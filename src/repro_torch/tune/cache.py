"""On-disk selection cache: persisted winners of the autotuning grid.

One JSON file maps **selection keys** to tuned winners, so that a later
process resolves ``auto`` choices (variant, block sizes) without measuring
again. The schema is the JAX package's (``repro/tune/cache.py``); a key
names what the ConnectIt and GPU follow-up papers say a winner depends on:

    <platform>/<device_kind>/<graph-family fingerprint>/<target>

* ``platform``/``device_kind`` — the session's device: ``cpu/cpu``, or
  ``cuda/<slug of torch.cuda.get_device_name>`` (``nvidia-h100-80gb-hbm3``),
  so that a ``device="cpu"`` session on a machine with a card never reads
  the card's winners (``backend_key``);
* fingerprint — the graph family, bucketed so one measurement covers the
  regime: ``n<log2-bucket>-<density>-<skew>`` (``fingerprint``). The
  wildcard family ``"*"`` holds device-global winners (block sizes are
  resolved before any graph is seen);
* ``target`` — ``"variant"`` or ``"block_m:<primitive>"``.

Durability contract, as in the reference:

* **schema versioning** — a file whose ``schema`` differs from
  ``SCHEMA_VERSION`` is discarded wholesale (never half-migrated);
* **contract invalidation** — every entry records the port's
  ``repro_torch.kernels.ops.KERNEL_CONTRACT_VERSION`` it was measured
  under; entries of another contract are dropped on load;
* **atomic writes** — the file is rewritten through a temp file and
  ``os.replace``, so a crash mid-write leaves the previous cache intact;
* **its own file** — ``REPRO_TORCH_TUNE_CACHE`` overrides the default
  ``~/.cache/repro_torch/tune.json`` (an explicit ``path=`` wins over the
  environment). The reference's ``REPRO_TUNE_CACHE`` is never read: on the
  CPU both packages key ``cpu/cpu/...``, and the reference's winners carry
  the reference's contract.

Corrupt or unreadable files are an empty cache: resolution falls back to
the defaults, never to an error.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Optional

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.ops import KERNEL_CONTRACT_VERSION

__all__ = [
    "SCHEMA_VERSION", "ENV_VAR", "SelectionCache", "cache_path",
    "default_cache", "reset_default_cache", "backend_key", "make_key",
    "fingerprint", "fingerprint_graph", "DENSITY_BUCKETS", "SKEW_THRESHOLD",
]

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
_DEFAULT_PATH = os.path.join("~", ".cache", "repro_torch", "tune.json")

# m/n thresholds for the density bucket (directed edges per vertex)
DENSITY_BUCKETS = ((4.0, "sparse"), (16.0, "mid"), (float("inf"), "dense"))
# max-degree / mean-degree ratio separating skewed (power-law-ish) families
SKEW_THRESHOLD = 8.0

_SAFE_RE = re.compile(r"[^a-z0-9._*-]+")


def _slug(text: str) -> str:
    return _SAFE_RE.sub("-", str(text).strip().lower()).strip("-") or "unknown"


def cache_path(path: Optional[str] = None) -> str:
    """The cache file: explicit ``path`` > ``REPRO_TORCH_TUNE_CACHE`` >
    ``~/.cache/repro_torch/tune.json``."""
    if path:
        return os.path.expanduser(path)
    env = os.environ.get(ENV_VAR, "").strip()
    if env:
        return os.path.expanduser(env)
    return os.path.expanduser(_DEFAULT_PATH)


def backend_key(device=DEFAULT_DEVICE) -> tuple:
    """``(platform, device_kind)`` of ``device``, slugged for keys:
    ``("cpu", "cpu")`` or ``("cuda", <slug of the card's name>)``. The
    default device is the card, and raises where there is none."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu", "cpu"
    import torch
    return "cuda", _slug(torch.cuda.get_device_name(dev))


def make_key(target: str, family: str = "*", *,
             device=DEFAULT_DEVICE) -> str:
    """Canonical selection key ``platform/device_kind/family/target``."""
    return "/".join((*backend_key(device), family, target))


# ---------------------------------------------------------------------------
# Graph-family fingerprints.
# ---------------------------------------------------------------------------

def fingerprint(n: int, m: int, skew_ratio: Optional[float] = None) -> str:
    """Bucketed graph-family fingerprint ``n<b>-<density>-<skew>``.

    ``n`` buckets by log2 (one winner per order of magnitude of vertices),
    density by directed edges per vertex, skew by the max/mean degree ratio
    (``None`` → ``any``: callers that cannot afford a degree pass still get
    a usable family key)."""
    nb = max(int(n), 1).bit_length() - 1
    per = m / max(n, 1)
    density = next(name for hi, name in DENSITY_BUCKETS if per < hi)
    if skew_ratio is None:
        skew = "any"
    else:
        skew = "hi" if skew_ratio >= SKEW_THRESHOLD else "lo"
    return f"n{nb}-{density}-{skew}"


def fingerprint_graph(g) -> str:
    """Fingerprint a ``repro_torch.graphs.Graph``: the degree skew from its
    CSR, one reduction over ``indptr`` and one host read of the maximum."""
    maxdeg = float(g.degrees()[: g.n].max()) if g.n else 0.0
    mean = g.m / max(g.n, 1)
    ratio = maxdeg / mean if mean > 0 else 1.0
    return fingerprint(g.n, g.m, ratio)


# ---------------------------------------------------------------------------
# The cache.
# ---------------------------------------------------------------------------

class SelectionCache:
    """Load/store tuned winners in one JSON file (see the module docstring).

    Reads are lazy and tolerant (a missing, corrupt or old-schema file is an
    empty cache); writes rewrite the whole file atomically. An instance
    holds an in-memory view loaded once: ``reload()`` picks up another
    process's writes."""

    def __init__(self, path: Optional[str] = None, *,
                 contract: int = KERNEL_CONTRACT_VERSION):
        self.path = cache_path(path)
        self.contract = int(contract)
        self._entries: Optional[dict] = None

    # -- reading -------------------------------------------------------------

    def _load(self) -> dict:
        if self._entries is not None:
            return self._entries
        entries: dict = {}
        try:
            with open(self.path) as f:
                data = json.load(f)
            if (isinstance(data, dict)
                    and data.get("schema") == SCHEMA_VERSION
                    and isinstance(data.get("entries"), dict)):
                # contract invalidation: drop winners measured under another
                # kernel dispatch contract
                entries = {
                    k: v for k, v in data["entries"].items()
                    if isinstance(v, dict)
                    and v.get("contract") == self.contract
                }
        except (OSError, ValueError):
            entries = {}
        self._entries = entries
        return entries

    def reload(self) -> "SelectionCache":
        self._entries = None
        self._load()
        return self

    def get(self, key: str) -> Optional[dict]:
        """The stored entry for ``key`` (``{"winner": ..., ...}``) or None."""
        return self._load().get(key)

    def winner(self, key: str):
        """The stored winner for ``key``, or None."""
        entry = self.get(key)
        return None if entry is None else entry.get("winner")

    def keys(self) -> list:
        return sorted(self._load())

    def __len__(self) -> int:
        return len(self._load())

    # -- writing -------------------------------------------------------------

    def put(self, key: str, winner, *, time_s: Optional[float] = None,
            **meta) -> dict:
        """Record ``winner`` under ``key`` and persist atomically."""
        entry = {"winner": winner, "contract": self.contract,
                 "tuned_at": time.time()}
        if time_s is not None:
            entry["time_s"] = float(time_s)
        entry.update(meta)
        entries = dict(self._load())
        entries[key] = entry
        self._write(entries)
        self._entries = entries
        return entry

    def discard(self, key: str) -> None:
        entries = dict(self._load())
        if entries.pop(key, None) is not None:
            self._write(entries)
            self._entries = entries

    def _write(self, entries: dict) -> None:
        payload = {"schema": SCHEMA_VERSION, "contract": self.contract,
                   "entries": entries}
        directory = os.path.dirname(self.path) or "."
        os.makedirs(directory, exist_ok=True)
        # atomic: a crash between write and replace leaves the old file
        fd, tmp = tempfile.mkstemp(prefix=".tune.", suffix=".tmp",
                                   dir=directory)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


_DEFAULT_CACHE: Optional[SelectionCache] = None


def default_cache() -> SelectionCache:
    """The process's cache at the default path (memoized; a changed
    ``REPRO_TORCH_TUNE_CACHE`` is read after ``reset_default_cache``, or
    when the path it names differs from the memoized one)."""
    global _DEFAULT_CACHE
    path = cache_path()
    if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != path:
        _DEFAULT_CACHE = SelectionCache(path)
    return _DEFAULT_CACHE


def reset_default_cache() -> None:
    """Drop the memoized default cache (tests; environment changes)."""
    global _DEFAULT_CACHE
    _DEFAULT_CACHE = None
