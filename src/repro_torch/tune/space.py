"""``TuneSpec``: the declarative search-space grammar of the autotuner.

The JAX package's grammar (``repro/tune/space.py``), with exact
``TuneSpec.parse(str(s)) == s`` round-trips:

    tune  := "tune" [ "(" opt ("," opt)* ")" ]
    opt   := "grid=" ("fast" | "full") | "trials=" INT | "warmup=" INT

``grid`` picks how much of the candidate space the tuner sweeps:

* ``fast`` (default) — the paper's §5-guidance shortlist of variants (one
  per recommended regime);
* ``full`` — every variant of ``enumerate_variants()`` (148).

Both sweep the same block ladder: on the card a connectivity kernel's
block is its threads a block, and the kernels are built for one,
``kernels.ops.DEFAULT_BLOCK_M`` (256), since no other size won beyond the
event spread on the H100 (PERF.md §6). The ladder keeps the reference's
``block_m`` targets, cache entries and CLI table over that one point.
``trials`` / ``warmup`` parameterize the measurement harness
(median of ``trials`` after ``warmup`` discarded runs — see
``repro_torch.tune.harness.time_fn``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Union

from ..kernels.ops import DEFAULT_BLOCK_M

__all__ = ["TuneSpec", "TuneSpecLike", "as_tune_spec", "GRIDS",
           "FAST_VARIANTS", "BLOCK_M_FAST", "BLOCK_M_FULL",
           "BLOCK_B_FAST", "BLOCK_B_FULL"]

GRIDS = ("fast", "full")

# the §5-guidance shortlist: one variant per recommended regime (sampling
# winner, no-sampling union-find ladder, the root-based SV alternative, and
# the paper-fastest Liu-Tarjan rule mix)
FAST_VARIANTS = (
    "kout_hybrid_k2+uf_sync_full",
    "kout_afforest_k2+uf_sync_halve",
    "none+uf_sync_full",
    "none+uf_sync_naive",
    "ldd_b0.2+uf_sync_full",
    "none+shiloach_vishkin",
    "none+liu_tarjan_CRFA",
)

# threads a block: the one size the kernels are built for
BLOCK_M_FAST = BLOCK_M_FULL = (DEFAULT_BLOCK_M,)
# the reference's bag-block ladders (legacy embedding_bag); nothing sweeps
# them, in either package
BLOCK_B_FAST = (512, 1024, 2048)
BLOCK_B_FULL = (128, 256, 512, 1024, 2048, 4096)

_TUNE_RE = re.compile(r"tune(?:\((.*)\))?")
_TUNE_DEFAULTS: dict = {}


@dataclasses.dataclass(frozen=True)
class TuneSpec:
    """Declarative autotuning configuration (grid × measurement budget)."""

    grid: str = "fast"
    trials: int = 3
    warmup: int = 1

    def __post_init__(self):
        if self.grid not in GRIDS:
            raise ValueError(f"unknown tune grid {self.grid!r}; have {GRIDS}")
        for name in ("trials", "warmup"):
            v = getattr(self, name)
            if int(v) != v:
                raise ValueError(f"{name} must be an integer, got {v!r}")
            object.__setattr__(self, name, int(v))
        if self.trials < 1:
            raise ValueError(f"trials must be >= 1, got {self.trials}")
        if self.warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {self.warmup}")

    # -- candidate spaces ----------------------------------------------------

    def variant_candidates(self) -> tuple:
        """Variant strings the tuner sweeps (fast shortlist or full grid)."""
        if self.grid == "fast":
            return FAST_VARIANTS
        from ..api import enumerate_variants  # lazy: api imports the tuner
        return tuple(str(v) for v in enumerate_variants())

    def policy_candidates(self) -> tuple:
        """The port has one dispatch, by tensor device, and no policy knob:
        ``("auto",)`` on every grid."""
        return ("auto",)

    def block_m_candidates(self) -> tuple:
        """Threads a block for the connectivity kernels."""
        return BLOCK_M_FAST if self.grid == "fast" else BLOCK_M_FULL

    def block_b_candidates(self) -> tuple:
        """Bag-block sizes (legacy batched kernels)."""
        return BLOCK_B_FAST if self.grid == "fast" else BLOCK_B_FULL

    # -- grammar -------------------------------------------------------------

    def __str__(self) -> str:
        opts = []
        if self.grid != _TUNE_DEFAULTS["grid"]:
            opts.append(f"grid={self.grid}")
        if self.trials != _TUNE_DEFAULTS["trials"]:
            opts.append(f"trials={self.trials}")
        if self.warmup != _TUNE_DEFAULTS["warmup"]:
            opts.append(f"warmup={self.warmup}")
        return "tune" + (f"({','.join(opts)})" if opts else "")

    @classmethod
    def parse(cls, text: str) -> "TuneSpec":
        m = _TUNE_RE.fullmatch(text.strip())
        if not m:
            raise ValueError(f"bad tune spec {text!r}; expected "
                             f"'tune(grid=fast|full,trials=N,warmup=N)'")
        kw: dict = {}
        optpart = m.group(1) or ""
        for opt in filter(None, (o.strip() for o in optpart.split(","))):
            key, eq, val = opt.partition("=")
            if key == "grid" and eq:
                kw["grid"] = val.strip()
            elif key == "trials" and eq:
                kw["trials"] = int(val)
            elif key == "warmup" and eq:
                kw["warmup"] = int(val)
            else:
                raise ValueError(f"bad tune option {opt!r} in {text!r}")
        return cls(**kw)


_TUNE_DEFAULTS.update({
    f.name: f.default for f in dataclasses.fields(TuneSpec)
})

TuneSpecLike = Union[str, TuneSpec]


def as_tune_spec(spec: TuneSpecLike) -> TuneSpec:
    if isinstance(spec, str):
        return TuneSpec.parse(spec)
    if isinstance(spec, TuneSpec):
        return spec
    raise TypeError(f"tune spec must be a TuneSpec or string, "
                    f"got {type(spec).__name__}")
