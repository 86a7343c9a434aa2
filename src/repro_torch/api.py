"""``VariantSpec`` / ``ConnectIt``: the declarative front-end of the port.

    ci = ConnectIt("kout_hybrid_k2+uf_sync_full")        # runs on the card
    labels = ci.connectivity(g)                          # g on the same device
    ci.stats

The grammar is the JAX package's (``repro.api``); canonical strings
round-trip, ``VariantSpec.parse(str(s)) == s``, and print as ``repro.api``
prints them. This slice of the port covers:

    variant  := sampling "+" finish
    sampling := "none" | "kout_" kvariant "_k" INT
    kvariant := "afforest" | "pure" | "hybrid" | "maxdeg"
    finish   := "uf_sync_" compress          (bare "uf_sync" = naive)
    compress := "naive" | "halve" | "full"

and the ``single`` placement. Every other part of the reference's surface
raises ``NotImplementedError`` naming the ROADMAP queue item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .core import driver
from .core.finish import COMPRESS_MODES, make_finish
from .core.sampling import KOUT_VARIANTS, make_kout
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["SamplingSpec", "FinishSpec", "VariantSpec", "ConnectIt",
           "KOUT_VARIANTS", "COMPRESS_MODES"]

SAMPLING_SCHEMES = ("none", "kout")
# the reference's other schemes and methods, and where the port takes them up
_LATER_SCHEMES = {"bfs": "Queue 1 item 6", "ldd": "Queue 1 item 6"}
_LATER_METHODS = {
    "shiloach_vishkin": "Queue 1 item 6", "label_prop": "Queue 1 item 6",
    "stergiou": "Queue 1 item 6", "liu_tarjan": "Queue 1 item 6",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """Declarative sampling-phase configuration (paper §3.2)."""

    scheme: str = "none"
    k: int = 2                 # kout: edges selected per vertex
    variant: str = "hybrid"    # kout: afforest | pure | hybrid | maxdeg

    def __post_init__(self):
        if self.scheme in _LATER_SCHEMES:
            raise _not_ported(f"sampling scheme {self.scheme!r}",
                              _LATER_SCHEMES[self.scheme])
        if self.scheme not in SAMPLING_SCHEMES:
            raise ValueError(f"unknown sampling scheme {self.scheme!r}; "
                             f"have {SAMPLING_SCHEMES}")
        if int(self.k) != self.k:
            raise ValueError(f"k must be an integer, got {self.k!r}")
        object.__setattr__(self, "k", int(self.k))
        if self.scheme == "kout":
            if self.variant not in KOUT_VARIANTS:
                raise ValueError(f"unknown k-out variant {self.variant!r}; "
                                 f"have {KOUT_VARIANTS}")
            if not 1 <= self.k <= 64:
                raise ValueError(f"kout k must be in [1, 64], got {self.k}")
        else:  # canonicalize: knobs 'none' does not use keep their defaults
            object.__setattr__(self, "k", 2)
            object.__setattr__(self, "variant", "hybrid")

    @property
    def enabled(self) -> bool:
        return self.scheme != "none"

    def build(self):
        """The sampler callable, or None for 'none'."""
        if not self.enabled:
            return None
        return make_kout(k=self.k, variant=self.variant)

    def __str__(self) -> str:
        if self.scheme == "none":
            return "none"
        return f"kout_{self.variant}_k{self.k}"

    @classmethod
    def parse(cls, text: str) -> "SamplingSpec":
        t = text.strip()
        if t in ("", "none"):
            return cls()
        parts = t.split("_")
        if parts[0] in _LATER_SCHEMES:
            raise _not_ported(f"sampling scheme {parts[0]!r}",
                              _LATER_SCHEMES[parts[0]])
        if parts[0] != "kout":
            raise ValueError(f"unknown sampling scheme in {text!r}; "
                             f"have {SAMPLING_SCHEMES}")
        kw: dict = {}
        for p in parts[1:]:
            if p in KOUT_VARIANTS:
                kw["variant"] = p
            elif p[:1] == "k" and p[1:].isdigit():
                kw["k"] = int(p[1:])
            else:
                raise ValueError(f"bad kout token {p!r} in {text!r}")
        return cls("kout", **kw)


@dataclasses.dataclass(frozen=True)
class FinishSpec:
    """Declarative finish-phase configuration (paper §3.3): the uf_sync
    family, with ``compress`` selecting FindNaive/FindHalve/FindCompress."""

    method: str = "uf_sync"
    compress: str = "naive"

    def __post_init__(self):
        if self.method in _LATER_METHODS:
            raise _not_ported(f"finish method {self.method!r}",
                              _LATER_METHODS[self.method])
        if self.method != "uf_sync":
            raise ValueError(f"unknown finish method {self.method!r}")
        if self.compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compress mode {self.compress!r}; "
                             f"have {COMPRESS_MODES}")

    def __str__(self) -> str:
        return f"uf_sync_{self.compress}"

    @classmethod
    def parse(cls, text: str) -> "FinishSpec":
        t = text.strip()
        if t == "uf_sync":  # alias: FindNaive analogue
            return cls("uf_sync", "naive")
        if t.startswith("uf_sync_"):
            return cls("uf_sync", t[len("uf_sync_"):])
        for method, item in _LATER_METHODS.items():
            if t == method or t.startswith(method + "_"):
                raise _not_ported(f"finish method {t!r}", item)
        raise ValueError(f"unknown finish method in {text!r}")


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One point of the paper's sampling × finish space."""

    sampling: SamplingSpec = SamplingSpec()
    finish: FinishSpec = FinishSpec()

    @classmethod
    def parse(cls, text: str) -> "VariantSpec":
        """Parse ``"<sampling>+<finish>"`` (or a bare ``"<finish>"``)."""
        if text.strip().lower() == "auto":
            raise _not_ported("'auto' variant resolution (the tuned "
                              "selection cache)", "Queue 1 item 14")
        if "+" in text:
            samp_part, fin_part = text.rsplit("+", 1)
        else:
            samp_part, fin_part = "none", text
        return cls(sampling=SamplingSpec.parse(samp_part),
                   finish=FinishSpec.parse(fin_part))

    @property
    def finish_str(self) -> str:
        return str(self.finish)

    def build_finish(self):
        return make_finish(self.finish.method, compress=self.finish.compress)

    def __str__(self) -> str:
        return f"{self.sampling}+{self.finish_str}"


SpecLike = Union[str, VariantSpec]


class ConnectIt:
    """One variant on one device: static connectivity.

    >>> ci = ConnectIt("kout_hybrid_k2+uf_sync_full")   # device="cuda"
    >>> labels = ci.connectivity(g)
    >>> ci.stats.finish_rounds

    ``device`` defaults to the card and raises where there is none; pass
    ``device="cpu"`` for the plain PyTorch path. The graph must live on the
    session's device. Only the ``single`` placement is ported."""

    def __init__(self, spec: SpecLike = "none+uf_sync_naive",
                 exec: str = "single", *, device=DEFAULT_DEVICE):
        if isinstance(spec, str):
            spec = VariantSpec.parse(spec)
        if not isinstance(spec, VariantSpec):
            raise TypeError(f"spec must be a VariantSpec or string, "
                            f"got {type(spec).__name__}")
        if str(exec).strip() != "single":
            raise _not_ported(f"execution spec {exec!r}", "Queue 1 item 13")
        self.spec = spec
        self.device = resolve_device(device)
        self._sampler = spec.sampling.build()
        self._finish = spec.build_finish()
        self._stats: Optional[driver.ConnectivityStats] = None

    def __repr__(self) -> str:
        return f"ConnectIt({str(self.spec)!r}, device={str(self.device)!r})"

    def connectivity(self, g, *, generator: Optional[torch.Generator] = None,
                     fused: bool = False, return_stats: bool = False):
        """Canonical min-vertex-id connectivity labels of ``g``, ``(n,)``
        int32 on the session's device. ``fused`` skips the compaction of
        L_max-internal edges. ``generator`` draws the random k-out columns
        (seeded 0 when None)."""
        if g.device != self.device:
            raise ValueError(f"graph lives on {g.device}, session on "
                             f"{self.device}")
        if fused:
            labels, stats = driver.run_connectivity_fused(
                g, self._sampler, self._finish, generator,
                variant=str(self.spec))
        else:
            labels, stats = driver.run_connectivity(
                g, self._sampler, self._finish, generator,
                variant=str(self.spec), pad="pow2")
        stats.exec = "single:fused" if fused else "single"
        self._stats = stats
        if return_stats:
            return labels, stats
        return labels

    @property
    def stats(self) -> Optional[driver.ConnectivityStats]:
        """ConnectivityStats of the last run."""
        return self._stats

    def spanning_forest(self, g, **kw):
        raise _not_ported("spanning_forest", "Queue 1 item 7")

    def stream(self, n: int, **kw):
        raise _not_ported("streaming connectivity", "Queue 1 items 8 and 10")

    def from_chunks(self, source, **kw):
        raise _not_ported("out-of-core ingest", "Queue 1 item 9")

    def amsf(self, g, weights, *a, **kw):
        raise _not_ported("the AMSF app", "Queue 1 item 11")

    def msf(self, g, weights, **kw):
        raise _not_ported("the MSF app", "Queue 1 item 11")

    def scan(self, g, sims, *a, **kw):
        raise _not_ported("the SCAN app", "Queue 1 item 11")

    def serve(self, n=None, **kw):
        raise _not_ported("serving", "Queue 1 item 12")
