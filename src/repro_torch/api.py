"""``VariantSpec`` / ``ConnectIt``: the declarative front-end of the port.

    ci = ConnectIt("kout_hybrid_k2+liu_tarjan_CRFA")     # runs on the card
    labels = ci.connectivity(g)                          # g on the same device
    ci.stats

The grammar is the JAX package's (``repro.api``); canonical strings
round-trip, ``VariantSpec.parse(str(s)) == s``, and print as ``repro.api``
prints them:

    variant  := sampling "+" finish
    sampling := "none"
              | "kout_" kvariant "_k" INT
              | "bfs_c" INT ["_t" FLOAT]
              | "ldd_b" FLOAT
    kvariant := "afforest" | "pure" | "hybrid" | "maxdeg"
    finish   := "uf_sync_" compress          (bare "uf_sync" = naive)
              | "shiloach_vishkin" | "label_prop" | "stergiou"
              | "liu_tarjan_" LTCODE          (bare "liu_tarjan" = CRFA)
    compress := "naive" | "halve" | "full"

``enumerate_variants()`` gives the paper's sampling × finish grid, 148
variants, in the reference's order. Besides static connectivity, a session
computes spanning forests (root-based finishes) and opens batch-incremental
and batch-dynamic streams:

    forest = ci.spanning_forest(g)                       # (k, 2) host array
    st = ci.stream(n)                                    # inserts + queries
    dyn = ci.stream(n, dynamic=True, log=1 << 20)        # + deletes
    labels = ci.from_chunks(ArrayEdgeSource(edges, n))   # out-of-core ingest
    forest = ci.amsf(g, with_weights(g), "amsf(skip=lmax)")   # paper §5.1
    labels, cores = ci.scan(g, sims, "scan(eps=0.6,mu=3)")    # paper §5.2
    server = ci.serve(n)                     # async serving (repro_torch.serve)

``exec=`` places the session (``core/execution.py``, the reference's
grammar): ``single`` on one device, or ``replicated(...)`` / ``sharded(...)``
over the ranks of a ``torch.distributed`` group, every rank making the same
calls (``repro_torch.launch.multihost``):

    ci = ConnectIt("kout_hybrid_k2+uf_sync_full", exec="sharded(x)")

Connectivity, streams, dynamic streams, AMSF, SCAN and serving run on the
placement; spanning forests, out-of-core ingest, ``amsf(mode=coo)`` and MSF
run on the single-device driver under any placement, as in the reference.
A served placement over several ranks runs the server on rank 0 and a
follower on every other rank (``repro_torch.serve.mesh``).

``ConnectIt("auto", device=...)`` takes the variant from the tuning cache
(``repro_torch.tune``): per graph family for ``connectivity``, the
device-global winner for every other surface, the paper's default on a
cold cache; with a ``:tune`` exec it measures the fast grid on the first
graph of each family and persists the winner:

    ci = ConnectIt("auto", exec="single:tune")
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import random as trandom
from .core import driver
from .core.apps import amsf as _amsf_impl
from .core.apps.spec import AppSpec, AppSpecLike, as_app_spec
from .core.execution import ExecutionSpec, as_execution_spec, make_backend
from .core.finish import (
    COMPRESS_MODES,
    FOREST_METHODS,
    LIU_TARJAN_VARIANTS,
    METHODS,
    make_finish,
    make_forest_finish,
)
from .core.sampling import KOUT_VARIANTS, make_sampler
from .device import DEFAULT_DEVICE, resolve_device
from .dynamic import engine as dyn_engine
from .graphs.ingest import ingest_chunks, ingest_stats

__all__ = ["SamplingSpec", "FinishSpec", "VariantSpec", "ExecutionSpec",
           "AppSpec", "AppSpecLike", "ConnectIt", "Stream", "DynamicStream",
           "enumerate_variants", "is_compatible",
           "default_sampling_grid", "default_finish_grid", "KOUT_VARIANTS",
           "COMPRESS_MODES", "LIU_TARJAN_VARIANTS"]

CONNECT_RULES = ("connect", "parent", "extended")
SHORTCUT_RULES = ("S", "F")

# reverse map: Liu–Tarjan rule options -> code ("CRFA", ...)
_LT_CODE_BY_OPTS = {opts: code for code, opts in LIU_TARJAN_VARIANTS.items()}

# the SamplingSpec knobs each scheme uses; the rest are pinned to their
# defaults, so equality and string round-trips are canonical
_SAMPLING_FIELDS = {
    "none": (),
    "kout": ("k", "variant"),
    "bfs": ("num_sources", "threshold"),
    "ldd": ("beta",),
}
SAMPLING_SCHEMES = tuple(_SAMPLING_FIELDS)
_SAMPLING_DEFAULTS: dict = {}  # filled from the dataclass fields below


def _fmt_float(x: float) -> str:
    # repr round-trips exactly through float(); "%g" would not
    return repr(float(x))


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """Declarative sampling-phase configuration (paper §3.2)."""

    scheme: str = "none"
    k: int = 2                 # kout: edges selected per vertex
    variant: str = "hybrid"    # kout: afforest | pure | hybrid | maxdeg
    beta: float = 0.2          # ldd: exponential-shift parameter
    num_sources: int = 3       # bfs: max sources tried
    threshold: float = 0.1     # bfs: coverage accept-gate fraction

    def __post_init__(self):
        if self.scheme not in SAMPLING_SCHEMES:
            raise ValueError(f"unknown sampling scheme {self.scheme!r}; "
                             f"have {SAMPLING_SCHEMES}")
        for name in ("k", "num_sources"):
            v = getattr(self, name)
            if int(v) != v:
                raise ValueError(f"{name} must be an integer, got {v!r}")
            object.__setattr__(self, name, int(v))
        object.__setattr__(self, "beta", float(self.beta))
        object.__setattr__(self, "threshold", float(self.threshold))
        if self.scheme == "kout":
            if self.variant not in KOUT_VARIANTS:
                raise ValueError(f"unknown k-out variant {self.variant!r}; "
                                 f"have {KOUT_VARIANTS}")
            if not 1 <= self.k <= 64:
                raise ValueError(f"kout k must be in [1, 64], got {self.k}")
        if self.scheme == "ldd" and not self.beta > 0.0:
            raise ValueError(f"ldd beta must be > 0, got {self.beta}")
        if self.scheme == "bfs":
            if self.num_sources < 1:
                raise ValueError(
                    f"bfs num_sources must be >= 1, got {self.num_sources}")
            if not 0.0 < self.threshold <= 1.0:
                raise ValueError(
                    f"bfs threshold must be in (0, 1], got {self.threshold}")
        live = _SAMPLING_FIELDS[self.scheme]
        for name, default in _SAMPLING_DEFAULTS.items():
            if name not in live:
                object.__setattr__(self, name, default)

    @property
    def enabled(self) -> bool:
        return self.scheme != "none"

    def factory_kwargs(self) -> dict:
        """kwargs for ``core.sampling.make_sampler(self.scheme, ...)``."""
        return {name: getattr(self, name)
                for name in _SAMPLING_FIELDS[self.scheme]}

    def build(self):
        """The memoized sampler callable, or None for 'none'."""
        if not self.enabled:
            return None
        return make_sampler(self.scheme, **self.factory_kwargs())

    def __str__(self) -> str:
        if self.scheme == "none":
            return "none"
        if self.scheme == "kout":
            return f"kout_{self.variant}_k{self.k}"
        if self.scheme == "bfs":
            s = f"bfs_c{self.num_sources}"
            if self.threshold != _SAMPLING_DEFAULTS["threshold"]:
                s += f"_t{_fmt_float(self.threshold)}"
            return s
        return f"ldd_b{_fmt_float(self.beta)}"

    @classmethod
    def parse(cls, text: str) -> "SamplingSpec":
        t = text.strip()
        if t in ("", "none"):
            return cls()
        scheme, *parts = t.split("_")
        kw: dict = {}
        if scheme == "kout":
            for p in parts:
                if p in KOUT_VARIANTS:
                    kw["variant"] = p
                elif p[:1] == "k" and p[1:].isdigit():
                    kw["k"] = int(p[1:])
                else:
                    raise ValueError(f"bad kout token {p!r} in {text!r}")
        elif scheme == "bfs":
            for p in parts:
                if p[:1] == "c" and p[1:].isdigit():
                    kw["num_sources"] = int(p[1:])
                elif p[:1] == "t":
                    kw["threshold"] = float(p[1:])
                else:
                    raise ValueError(f"bad bfs token {p!r} in {text!r}")
        elif scheme == "ldd":
            for p in parts:
                if p[:1] != "b":
                    raise ValueError(f"bad ldd token {p!r} in {text!r}")
                kw["beta"] = float(p[1:])
        else:
            raise ValueError(f"unknown sampling scheme in {text!r}; "
                             f"have {SAMPLING_SCHEMES}")
        return cls(scheme, **kw)


_SAMPLING_DEFAULTS.update({
    f.name: f.default for f in dataclasses.fields(SamplingSpec)
    if f.name != "scheme"
})


@dataclasses.dataclass(frozen=True)
class FinishSpec:
    """Declarative finish-phase configuration (paper §3.3).

    ``compress`` selects FindNaive/FindHalve/FindCompress of the uf_sync
    family and is pinned to its default for the other methods. The
    Liu–Tarjan rule options live on ``VariantSpec``."""

    method: str = "uf_sync"
    compress: str = "naive"

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown finish method {self.method!r}; "
                             f"have {METHODS}")
        if self.method == "uf_sync":
            if self.compress not in COMPRESS_MODES:
                raise ValueError(f"unknown compress mode {self.compress!r}; "
                                 f"have {COMPRESS_MODES}")
        else:
            object.__setattr__(self, "compress", "naive")

    def __str__(self) -> str:
        if self.method == "uf_sync":
            return f"uf_sync_{self.compress}"
        return self.method


def _parse_finish_part(text: str) -> tuple[FinishSpec, dict]:
    """finish token -> (FinishSpec, Liu–Tarjan option overrides)."""
    t = text.strip()
    if t == "uf_sync":  # alias: FindNaive analogue
        return FinishSpec("uf_sync", "naive"), {}
    if t.startswith("uf_sync_"):
        return FinishSpec("uf_sync", t[len("uf_sync_"):]), {}
    if t in ("shiloach_vishkin", "label_prop", "stergiou"):
        return FinishSpec(t), {}
    if t == "liu_tarjan":  # alias: the paper-fastest LT variant
        t = "liu_tarjan_CRFA"
    if t.startswith("liu_tarjan_"):
        code = t[len("liu_tarjan_"):]
        if code not in LIU_TARJAN_VARIANTS:
            raise ValueError(f"unknown Liu-Tarjan code {code!r}; "
                             f"have {sorted(LIU_TARJAN_VARIANTS)}")
        connect, rootup, shortcut, alter = LIU_TARJAN_VARIANTS[code]
        return FinishSpec("liu_tarjan"), dict(
            connect=connect, rootup=rootup, shortcut=shortcut, alter=alter)
    raise ValueError(f"unknown finish method in {text!r}")


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One point of the paper's sampling × finish × compression space."""

    sampling: SamplingSpec = SamplingSpec()
    finish: FinishSpec = FinishSpec()
    # Liu–Tarjan rule options (paper §3.3.2 / Appendix D.4); meaningful only
    # when finish.method == "liu_tarjan", pinned to defaults otherwise. The
    # defaults spell CRFA, as the bare "liu_tarjan" alias does.
    connect: str = "connect"   # Connect | ParentConnect | ExtendedConnect
    rootup: bool = True        # update roots only (R) vs unconditional (U)
    shortcut: str = "F"        # one jump round (S) vs compress to fixpoint (F)
    alter: bool = True         # rewrite edge endpoints to parent ids

    def __post_init__(self):
        if self.finish.method == "liu_tarjan":
            if self.connect not in CONNECT_RULES:
                raise ValueError(f"unknown connect rule {self.connect!r}; "
                                 f"have {CONNECT_RULES}")
            if self.shortcut not in SHORTCUT_RULES:
                raise ValueError(f"unknown shortcut rule {self.shortcut!r}; "
                                 f"have {SHORTCUT_RULES}")
            opts = (self.connect, bool(self.rootup), self.shortcut,
                    bool(self.alter))
            if opts not in _LT_CODE_BY_OPTS:
                raise ValueError(
                    f"Liu-Tarjan rule combination {opts} is not one of the "
                    f"paper's valid variants (Table 1); valid codes: "
                    f"{sorted(LIU_TARJAN_VARIANTS)}")
        else:
            object.__setattr__(self, "connect", "connect")
            object.__setattr__(self, "rootup", True)
            object.__setattr__(self, "shortcut", "F")
            object.__setattr__(self, "alter", True)

    @classmethod
    def parse(cls, text: str, *, device=DEFAULT_DEVICE) -> "VariantSpec":
        """Parse ``"<sampling>+<finish>"`` (or a bare ``"<finish>"``).

        ``"auto"`` resolves through the tuning cache (``repro_torch.tune``):
        the device-global winner tuned on ``device``, else the paper's
        recommended default. A resolution request, not a canonical form, so
        it does not round-trip; ``device`` is read for ``"auto"`` only."""
        if text.strip().lower() == "auto":
            from .tune.tuner import resolve_variant  # lazy: tune imports api
            return cls.parse(resolve_variant(device=device))
        if "+" in text:
            # split on the LAST '+': finish tokens never contain one, while
            # a float sampling parameter may (repr(1e16) == '1e+16')
            samp_part, fin_part = text.rsplit("+", 1)
        else:
            samp_part, fin_part = "none", text
        finish, lt_opts = _parse_finish_part(fin_part)
        return cls(sampling=SamplingSpec.parse(samp_part), finish=finish,
                   **lt_opts)

    @classmethod
    def liu_tarjan(cls, code: str,
                   sampling: SamplingSpec = SamplingSpec()) -> "VariantSpec":
        """The variant of one Liu–Tarjan code ("CRFA", ...)."""
        finish, lt_opts = _parse_finish_part(f"liu_tarjan_{code}")
        return cls(sampling=sampling, finish=finish, **lt_opts)

    @property
    def lt_code(self) -> Optional[str]:
        if self.finish.method != "liu_tarjan":
            return None
        return _LT_CODE_BY_OPTS[(self.connect, self.rootup, self.shortcut,
                                 self.alter)]

    @property
    def finish_str(self) -> str:
        if self.finish.method == "liu_tarjan":
            return f"liu_tarjan_{self.lt_code}"
        return str(self.finish)

    def finish_kwargs(self) -> dict:
        """kwargs for ``core.finish.make_finish(self.finish.method, ...)``."""
        if self.finish.method == "uf_sync":
            return dict(compress=self.finish.compress)
        if self.finish.method == "liu_tarjan":
            return dict(variant=self.lt_code)
        return {}

    def build_finish(self):
        """The memoized finish callable."""
        return make_finish(self.finish.method, **self.finish_kwargs())

    @property
    def forest_capable(self) -> bool:
        """True iff the finish method supports root-based forest recording
        (paper §3.4 / Theorem 6): the uf_sync family and Shiloach-Vishkin."""
        return self.finish.method in FOREST_METHODS

    @property
    def forest_compress(self) -> str:
        """The per-round compression the forest step runs under (SV's round
        is hook + full compression by definition)."""
        return (self.finish.compress if self.finish.method == "uf_sync"
                else "full")

    def build_forest_finish(self):
        """The memoized root-based forest step ``(P, s, r, fu, fv) ->
        (ForestState, rounds)``. Raises for non-forest-capable methods."""
        if not self.forest_capable:
            raise ValueError(
                f"forest recording requires a root-based finish "
                f"({'/'.join(FOREST_METHODS)}), not {self.finish_str!r} — "
                f"paper §3.4")
        kw = ({"compress": self.finish.compress}
              if self.finish.method == "uf_sync" else {})
        return make_forest_finish(self.finish.method, **kw)

    def __str__(self) -> str:
        return f"{self.sampling}+{self.finish_str}"


# ---------------------------------------------------------------------------
# Variant-space enumeration (paper §3, Table 1 cross-product).
# ---------------------------------------------------------------------------

def is_compatible(sampling: SamplingSpec, finish_str: str) -> bool:
    """The paper's composition rule: Stergiou's two-array algorithm starts
    from the identity labeling (paper B.2.5), so no sampler precedes it.
    Invalid Liu–Tarjan rule mixes are not representable at all."""
    return not (sampling.enabled and finish_str == "stergiou")


def default_sampling_grid() -> list[SamplingSpec]:
    """The paper's sampling schemes at their Table-1 parameterizations."""
    return ([SamplingSpec()]
            + [SamplingSpec("kout", k=2, variant=v) for v in KOUT_VARIANTS]
            + [SamplingSpec("bfs"), SamplingSpec("ldd")])


def default_finish_grid() -> list[str]:
    """Every finish × compression parameterization the paper evaluates."""
    return ([f"uf_sync_{c}" for c in COMPRESS_MODES]
            + ["shiloach_vishkin", "label_prop", "stergiou"]
            + [f"liu_tarjan_{code}" for code in sorted(LIU_TARJAN_VARIANTS)])


def enumerate_variants(
    samplings: Optional[Sequence[SamplingSpec]] = None,
    finishes: Optional[Sequence[str]] = None,
) -> list[VariantSpec]:
    """The sampling × finish cross-product without the incompatible pairs:
    with the default grids, 7 samplings × 22 finishes − 6 = 148 variants."""
    samplings = default_sampling_grid() if samplings is None else samplings
    finishes = default_finish_grid() if finishes is None else finishes
    out = []
    for s in samplings:
        for f in finishes:
            if is_compatible(s, f):
                finish, lt_opts = _parse_finish_part(f)
                out.append(VariantSpec(sampling=s, finish=finish, **lt_opts))
    return out


SpecLike = Union[str, VariantSpec]
ExecLike = Union[str, ExecutionSpec]


def _as_index(x, device) -> torch.Tensor:
    """A 1-D int32 tensor of ``x`` (a sequence, numpy array or tensor) on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1)
    return torch.from_numpy(np.array(x, dtype=np.int32).reshape(-1)).to(
        device)


def _pad(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    k = x.shape[0]
    return x if size == k else torch.cat([x, x.new_full((size - k,), fill)])


class Stream:
    """Batch-incremental connectivity bound to one finish variant and one
    execution placement (paper §3.5 / Algorithm 3).

    Batches are padded under the placement's pad policy (the next power of
    two by default, a multiple of the edge shards) with the dump id ``n``
    (query batches with vertex 0), so a ragged last batch reuses an earlier
    shape. On a mesh placement every rank passes the whole batch and
    inserts its own block of it; answers and labels are whole on every
    rank, and ``labels`` and ``num_components`` are collectives that every
    rank calls. The counters stay on the device and are read only by
    ``stats`` and ``edges_inserted``."""

    def __init__(self, n: int, finish_fn, *, backend, variant: str = ""):
        self.n = n
        self.variant = variant
        self._backend = backend
        self.device = backend.device
        self._ops = backend.stream_ops(n, finish_fn)
        self.state = self._ops.init()
        self.batches = 0
        self._dispatch_sizes: list[int] = []
        # directed real entries per edge shard (each shard mirrors its own
        # block, hence twice its real edges)
        self._edges_dev = torch.zeros((self._ops.edge_shards,),
                                      dtype=torch.int64, device=self.device)
        self._rounds = 0  # the finish loops count rounds on the host

    def _pad_batch(self, u, v):
        u, v = _as_index(u, self.device), _as_index(v, self.device)
        size = self._ops.batch_size(u.shape[0])
        return _pad(u, size, self.n), _pad(v, size, self.n), size

    def _pad_queries(self, qa, qb):
        qa, qb = _as_index(qa, self.device), _as_index(qb, self.device)
        k = qa.shape[0]
        size = self._ops.batch_size(k)
        return _pad(qa, size, 0), _pad(qb, size, 0), k

    def _account(self, u, size: int, rounds: int) -> None:
        self.batches += 1
        self._dispatch_sizes.append(size)
        real = (u < self.n).reshape(self._ops.edge_shards, -1)
        self._edges_dev += 2 * real.sum(1)
        self._rounds += int(rounds)

    def insert(self, u, v) -> "Stream":
        """Insert one batch of undirected edges (symmetrized internally)."""
        u, v, size = self._pad_batch(u, v)
        self.state, rounds = self._ops.insert(self.state, u, v)
        self._account(u, size, rounds)
        return self

    def query(self, qa, qb) -> torch.Tensor:
        """IsConnected for each (qa[i], qb[i]) pair."""
        qa, qb, k = self._pad_queries(qa, qb)
        return self._ops.query(self.state, qa, qb)[:k]

    def process(self, u, v, qa, qb) -> torch.Tensor:
        """Inserts, then queries against the result (paper Algorithm 3)."""
        u, v, size = self._pad_batch(u, v)
        qa, qb, k = self._pad_queries(qa, qb)
        self.state, ans, rounds = self._ops.process(self.state, u, v, qa, qb)
        self._account(u, size, rounds)
        return ans[:k]

    @property
    def edges_inserted(self) -> int:
        """Real (non-padding) edges inserted so far (syncs on read)."""
        return int(self._edges_dev.sum()) // 2

    @property
    def labels(self) -> torch.Tensor:
        """Current compressed labeling over real vertices (n,)."""
        return self._ops.labels(self.state)

    def num_components(self) -> int:
        return int(self._ops.ncomp(self.state))

    @property
    def stats(self) -> driver.ConnectivityStats:
        """ConnectivityStats of the stream so far (syncs on read). Batches
        are symmetrized, so ``edges_finish`` is twice ``edges_inserted``,
        and ``edges_per_device`` sums to it; ``dispatch_sizes`` (padded per
        edge shard, summed over batches) sums to ``edges_finish_padded``;
        ``batch_shapes`` is the distinct padded batch sizes."""
        spec = self._backend.spec
        shards = self._ops.edge_shards
        edges = self.edges_inserted
        padded = 2 * sum(self._dispatch_sizes)
        return driver.ConnectivityStats(
            variant=self.variant, exec=str(spec), placement=spec.placement,
            devices=self._backend.devices, fused=spec.fused,
            edges_total=edges, edges_finish=2 * edges,
            edges_finish_padded=padded,
            edges_per_device=tuple(self._edges_dev.tolist()),
            dispatch_sizes=(padded // shards,) * shards,
            batch_shapes=tuple(sorted(set(self._dispatch_sizes))),
            finish_rounds=self._rounds)


class DynamicStream:
    """Batch-dynamic connectivity: mixed insert/delete/query batches
    (``repro_torch.dynamic``), bound to one forest-capable variant and one
    execution placement.

    The device state extends the stream labeling with the spanning forest
    (recorded during inserts) and a fixed-capacity tombstoned edge log.
    Deletions that miss the forest cost only the tombstone; forest hits
    start the bounded replacement search (``search_rounds`` rounds, then a
    rebuild of the affected components). Within one batch the order is
    deletes, inserts, queries. On a mesh placement the labels follow the
    placement, the forest is whole on every rank and the log is split like
    insert batches; every rank passes the whole batches.

    The three size axes (deletes, inserts, queries) are padded apart under
    the placement's pad policy. Log capacity is tracked on the host with a
    per-shard bound that ignores tombstones; the true per-shard occupancy
    is read from the device only when the bound would overflow."""

    def __init__(self, n: int, *, backend, variant: str = "",
                 compress: str = "full", log: int = 0,
                 search_rounds: int = dyn_engine.DEFAULT_SEARCH_ROUNDS):
        self.n = n
        self.variant = variant
        self._backend = backend
        self.device = backend.device
        self._ops = backend.dynamic_ops(n, compress=compress, log=log,
                                        search_rounds=search_rounds)
        self._exec = dataclasses.replace(backend.spec, dynamic=True, log=log)
        self.state = self._ops.init()
        self.batches = 0
        self._dispatch_sizes: list[int] = []
        self._edges = torch.zeros((), dtype=torch.int64, device=self.device)
        self._deletes = torch.zeros((), dtype=torch.int64,
                                    device=self.device)
        self._rounds = 0
        # per-shard occupancy bound (tombstones never shrink it; a predicted
        # overflow reads the true per-shard live counts)
        shards = self._ops.edge_shards
        self._cap_local = self._ops.log_cap // shards
        self._bound = np.zeros((shards,), np.int64)

    def _pad(self, u, v, size_fn):
        u, v = _as_index(u, self.device), _as_index(v, self.device)
        k = u.shape[0]
        size = size_fn(k)
        return _pad(u, size, self.n), _pad(v, size, self.n), k, size

    def _ensure_capacity(self, k: int, size: int) -> None:
        incoming = np.asarray(driver._per_chunk_counts(
            k, size, self._ops.edge_shards))
        if (self._bound + incoming <= self._cap_local).all():
            self._bound += incoming
            return
        # the bound ignores tombstones: read the true occupancy once, then
        # check again (the only sync on the capacity path)
        self._bound = self._ops.used(self.state).cpu().numpy().astype(
            np.int64)
        if (self._bound + incoming > self._cap_local).any():
            raise ValueError(
                f"edge log full: shard occupancy {self._bound.tolist()} + "
                f"batch {incoming.tolist()} exceeds {self._cap_local} "
                f"slots/shard — build the stream with a larger log= "
                f"(total capacity {self._ops.log_cap})")
        self._bound += incoming

    def process(self, du, dv, u, v, qa, qb) -> torch.Tensor:
        """One mixed batch: delete ``(du, dv)``, insert ``(u, v)``, then
        answer ``(qa, qb)``."""
        du, dv, _, _ = self._pad(du, dv, self._ops.delete_size)
        u, v, k, size = self._pad(u, v, self._ops.batch_size)
        qa, qb, qk, _ = self._pad(qa, qb, self._ops.batch_size)
        self._ensure_capacity(k, size)
        self.state, ans, rounds = self._ops.update(
            self.state, du, dv, u, v, qa, qb)
        self.batches += 1
        self._dispatch_sizes.append(size)
        self._edges += (u < self.n).sum()
        self._deletes += (du < self.n).sum()
        self._rounds += int(rounds)
        return ans[:qk]

    def insert(self, u, v) -> "DynamicStream":
        """Insert one batch of undirected edges."""
        empty = np.empty((0,), np.int32)
        self.process(empty, empty, u, v, empty, empty)
        return self

    def delete(self, u, v) -> "DynamicStream":
        """Delete one batch of undirected edges (every logged copy of each
        pair goes; pairs not present are ignored)."""
        empty = np.empty((0,), np.int32)
        self.process(u, v, empty, empty, empty, empty)
        return self

    def query(self, qa, qb) -> torch.Tensor:
        """IsConnected for each (qa[i], qb[i]) pair."""
        qa, qb, qk, _ = self._pad(qa, qb, self._ops.batch_size)
        return self._ops.query(self.state, qa, qb)[:qk]

    @property
    def edges_inserted(self) -> int:
        """Real (non-padding) insert entries so far (syncs on read)."""
        return int(self._edges)

    @property
    def edges_deleted(self) -> int:
        """Real (non-padding) delete entries so far (syncs on read)."""
        return int(self._deletes)

    @property
    def labels(self) -> torch.Tensor:
        return self._ops.labels(self.state)

    def num_components(self) -> int:
        return int(self._ops.ncomp(self.state))

    def log_used(self) -> int:
        """Live (non-tombstoned) edge-log entries (syncs)."""
        return int(self._ops.used(self.state).sum())

    def forest_edges(self) -> np.ndarray:
        """Current spanning-forest edges, a host (k, 2) int32 array."""
        return driver.forest_edges(*self._ops.forest(self.state))

    @property
    def stats(self) -> driver.ConnectivityStats:
        """ConnectivityStats of the dynamic stream (syncs on read).
        ``edges_total`` counts inserts net of deletes submitted;
        ``edges_finish`` is twice the inserts, as for ``Stream``."""
        spec = self._exec
        shards = self._ops.edge_shards
        padded = 2 * sum(self._dispatch_sizes)
        return driver.ConnectivityStats(
            variant=self.variant, exec=str(spec), placement=spec.placement,
            devices=self._backend.devices, fused=spec.fused,
            edges_total=self.edges_inserted - self.edges_deleted,
            edges_finish=2 * self.edges_inserted,
            edges_finish_padded=padded,
            dispatch_sizes=(padded // shards,) * shards,
            batch_shapes=tuple(sorted(set(self._dispatch_sizes))),
            finish_rounds=self._rounds)


def _check_exec(spec: ExecutionSpec) -> None:
    """Refuse the knob that parses but does not run in the port."""
    if spec.kernels != "auto":
        raise ValueError(
            f"kernels={spec.kernels} has no meaning in repro_torch: it "
            f"dispatches by tensor device, with no policy knob (a CPU tensor "
            f"takes the plain version, a CUDA tensor the CUDA kernel)")


class ConnectIt:
    """One variant × one execution placement: static connectivity,
    spanning forests, streams, out-of-core ingest, the §5 apps (AMSF, MSF,
    SCAN) and serving.

    >>> ci = ConnectIt("kout_hybrid_k2+uf_sync_full")   # device="cuda"
    >>> labels = ci.connectivity(g)
    >>> ci.stats.finish_rounds

    ``device`` defaults to the card and raises where there is none; pass
    ``device="cpu"`` for the plain PyTorch path. The graph must live on the
    session's device. ``exec`` is an ExecutionSpec (string); a mesh
    placement runs over the ranks of the ``torch.distributed`` group (one
    rank when none is configured), on ``mesh`` when one is given: a
    ``DeviceMesh`` that names the spec's axes.

    ``ConnectIt("auto", ...)`` leaves the variant to the tuning cache of
    the session's device (``repro_torch.tune``): each ``.connectivity(g)``
    resolves the winner recorded for ``g``'s graph-family fingerprint, else
    the device-global winner, else the paper's recommended default. A
    lookup, memoized per family, so a warm call measures nothing. With the
    ``tune`` exec opt the session instead measures the fast grid on the
    first graph of each family it sees and persists the winner. The other
    surfaces (forests, streams, ingest, the apps, serving) bind the
    device-global winner at construction. On a mesh placement the mesh's
    first rank resolves (its cache, its fingerprint) and every rank runs
    its variant, so that ranks with different cache files run one
    program."""

    def __init__(self, spec: SpecLike = "none+uf_sync_naive",
                 exec: ExecLike = "single", *, mesh=None,
                 device=DEFAULT_DEVICE):
        auto = isinstance(spec, str) and spec.strip().lower() == "auto"
        if isinstance(spec, str) and not auto:
            spec = VariantSpec.parse(spec)
        if not (auto or isinstance(spec, VariantSpec)):
            raise TypeError(f"spec must be a VariantSpec or string, "
                            f"got {type(spec).__name__}")
        exec_spec = as_execution_spec(exec)
        _check_exec(exec_spec)
        self.exec = exec_spec
        self.device = resolve_device(device)
        if exec_spec.placement != "single" and mesh is None:
            import torch.distributed as dist

            from .launch.multihost import initialize
            if not dist.is_initialized():
                initialize()  # the configured group, else one rank
        self._backend = make_backend(exec_spec, mesh=mesh, device=self.device)
        self._auto = auto
        self._auto_specs: dict = {}      # family fingerprint -> programs
        self._tuned_families: set = set()
        if auto:
            from .tune.tuner import resolve_variant  # lazy: tune imports api
            spec = VariantSpec.parse(self._on_leader(
                lambda: resolve_variant(device=self.device)))
        self.spec = spec
        self._sampler = spec.sampling.build()
        self._finish = spec.build_finish()
        self._stats: Optional[driver.ConnectivityStats] = None

    def __repr__(self) -> str:
        ex = ("" if self.exec == ExecutionSpec()
              else f", exec={str(self.exec)!r}")
        return (f"ConnectIt({str(self.spec)!r}{ex}, "
                f"device={str(self.device)!r})")

    def _on_leader(self, fn):
        """``fn()`` on the mesh's origin rank (coordinate 0 on every axis),
        passed to every rank of the mesh (each makes this call); ``fn()``
        where the placement has no mesh."""
        mesh = self._backend.mesh
        if mesh is None:
            return fn()
        import torch.distributed as dist

        from .core import collectives as coll
        mine = fn() if dist.get_rank() == coll.origin_rank(mesh) else None
        return coll.broadcast_object(mine, mesh, device=self.device)

    def _resolve_auto(self, g) -> tuple:
        """(spec, sampler, finish) of an ``"auto"`` session for ``g``: the
        cached winner of its family fingerprint, memoized per family. Under
        the ``tune`` exec opt the first graph of each family is measured
        once a session (``tune_variant``; on a mesh every rank measures and
        the mesh's origin writes) and the winner persisted."""
        from .tune.cache import fingerprint_graph
        from .tune.tuner import resolve_variant, tune_variant
        fam = self._on_leader(lambda: fingerprint_graph(g))
        if self.exec.tune and fam not in self._tuned_families:
            tune_variant(g, family=fam,
                         exec=str(dataclasses.replace(self.exec, tune=False)),
                         mesh=self._backend.mesh)
            self._tuned_families.add(fam)
            self._auto_specs.pop(fam, None)
        if fam not in self._auto_specs:
            spec = VariantSpec.parse(self._on_leader(
                lambda: resolve_variant(fam, device=self.device)))
            self._auto_specs[fam] = (spec, spec.sampling.build(),
                                     spec.build_finish())
        return self._auto_specs[fam]

    def connectivity(self, g, *, key: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     fused: Optional[bool] = None,
                     return_stats: bool = False):
        """Canonical min-vertex-id connectivity labels of ``g``, ``(n,)``
        int32 on the session's device (whole on every rank). ``fused``
        skips the compaction of L_max-internal edges; on a mesh placement
        it is part of the ExecutionSpec and cannot be overridden per call.
        ``key`` draws the sampler's random numbers (k-out columns, BFS
        sources, LDD shifts) as the reference's ``key`` does, with its
        default ``PRNGKey(0)`` (``repro_torch.random``), so the stats equal
        ``repro``'s; ``generator`` draws torch's numbers instead (one of the
        two, not both). On a mesh every rank draws the same. An ``"auto"``
        session resolves the variant for ``g``'s family first."""
        self._check_device(g)
        rng = trandom.choose(key, generator)
        spec, sampler, finish = ((self.spec, self._sampler, self._finish)
                                 if not self._auto else self._resolve_auto(g))
        labels, stats = self._backend.connectivity(
            g, sampler, finish, rng, variant=str(spec), fused=fused)
        self._stats = stats
        if return_stats:
            return labels, stats
        return labels

    def connected_components(self, g, **kw) -> np.ndarray:
        """Convenience: ``connectivity``'s labels as a host numpy array."""
        return self.connectivity(g, **kw).cpu().numpy()

    @property
    def stats(self) -> Optional[driver.ConnectivityStats]:
        """ConnectivityStats of the last run."""
        return self._stats

    def _check_device(self, g) -> None:
        if g.device != self.device:
            raise ValueError(f"graph lives on {g.device}, session on "
                             f"{self.device}")

    def spanning_forest(self, g, *, key: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> np.ndarray:
        """Spanning forest edges, a host ``(k, 2)`` int32 array (paper
        §3.4). Valid only for root-based finish methods (the uf_sync family
        and Shiloach-Vishkin): the forest invariant needs one recorded edge
        per hooked root. ``key``/``generator`` as for ``connectivity``.
        ``stats`` holds the run's ConnectivityStats."""
        if not self.spec.forest_capable:
            raise ValueError(
                f"spanning forest requires a root-based finish "
                f"({'/'.join(FOREST_METHODS)}), not "
                f"{self.spec.finish_str!r} — paper §3.4")
        self._check_device(g)
        edges, self._stats = self._backend.spanning_forest(
            g, self._sampler, trandom.choose(key, generator),
            compress=self.spec.forest_compress,
            variant=str(self.spec))
        return edges

    def stream(self, n: int, *, dynamic: Optional[bool] = None,
               log: Optional[int] = None,
               search_rounds: int = dyn_engine.DEFAULT_SEARCH_ROUNDS
               ) -> Union[Stream, DynamicStream]:
        """A fresh batch-incremental handle over ``n`` vertices (paper
        §3.5) under this session's placement.

        With ``dynamic=True`` (or an exec carrying the ``dynamic`` opt) the
        handle is a ``DynamicStream``: mixed insert/delete/query batches
        backed by a spanning forest and a tombstoned edge log of capacity
        ``log`` (a power of two; default the exec's ``log=``, else the next
        power of two >= 4n). It needs a root-based finish.
        ``search_rounds`` bounds the replacement search before a deletion
        falls back to rebuilding the affected components."""
        dyn = self.exec.dynamic if dynamic is None else bool(dynamic)
        if not dyn:
            if log:
                raise ValueError("log= is a dynamic-stream knob — pass "
                                 "dynamic=True (or use a ':dynamic' exec)")
            return Stream(n, self._finish, backend=self._backend,
                          variant=str(self.spec))
        if not self.spec.forest_capable:
            raise ValueError(
                f"dynamic streams maintain a spanning forest and need a "
                f"root-based finish ({'/'.join(FOREST_METHODS)}), not "
                f"{self.spec.finish_str!r} — paper §3.4")
        cap = self.exec.log if log is None else log
        if cap and cap & (cap - 1):
            raise ValueError(f"log must be a power of two, got {cap}")
        return DynamicStream(n, backend=self._backend,
                             variant=str(self.spec),
                             compress=self.spec.forest_compress, log=cap,
                             search_rounds=search_rounds)

    def from_chunks(self, source, *, key: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    survivor_cap: Optional[int] = None,
                    sample_chunks: int = 1, return_stats: bool = False):
        """Out-of-core connectivity over a ``ChunkedEdgeSource``
        (``repro_torch.graphs.ingest``), on the session's device.

        The sampling phase runs on the stream's head; then every chunk goes
        through relabel-and-filter into a bounded survivor buffer. The
        labels equal ``.connectivity``'s on the same edges. ``key``/
        ``generator`` as for ``connectivity``. ``.stats`` reports the
        chunks, spills and survivors beside the usual fields."""
        result = ingest_chunks(
            source, self._sampler, self._finish,
            trandom.choose(key, generator),
            device=self.device, survivor_cap=survivor_cap,
            sample_chunks=sample_chunks)
        stats = ingest_stats(result, variant=str(self.spec))
        self._stats = stats
        if return_stats:
            return result.labels, stats
        return result.labels

    # -- applications (paper §5): AMSF / exact MSF / SCAN -------------------

    def _app_stats(self, app: AppSpec, g) -> driver.ConnectivityStats:
        stats = self._backend._base_stats(str(self.spec))
        stats.app = str(app)
        stats.edges_total = g.m
        return stats

    def amsf(self, g, weights, spec: AppSpecLike = "amsf", *,
             return_stats: bool = False) -> np.ndarray:
        """Approximate minimum spanning forest (paper §5.1) → host ``(k,
        2)`` edges; its weight is within ``(1 + eps)`` of the exact MSF.

        ``spec`` names the paper variant (``amsf`` = AMSF-NF,
        ``amsf(skip=lmax)`` = AMSF-NF-S, ``amsf(mode=coo)`` = AMSF-COO,
        ``msf`` = exact Borůvka). Each bucket's forest step is this
        session's finish method, which must be root-based (the uf_sync
        family or Shiloach-Vishkin). ``weights`` is the ``(m_pad,)``
        float32 tensor of ``with_weights`` on the graph's device. Fills
        ``.stats`` (buckets, edges per bucket, rounds, dispatch sizes)."""
        app = as_app_spec(spec)
        if app.app == "scan":
            raise ValueError("scan specs run via .scan(g, sims, spec)")
        self._check_device(g)
        stats = self._app_stats(app, g)
        weights = torch.as_tensor(weights, device=self.device)
        if app.app == "msf":
            edges, _ = _amsf_impl.boruvka_msf(g, weights)
            # Borůvka is one single-device program under every placement,
            # as in the reference: the stats say what ran
            stats.exec = "single"
            stats.placement = "single"
            stats.devices = 1
            stats.edges_finish = g.m
            stats.edges_finish_padded = g.m_pad
            stats.edges_per_device = (g.m,)
            stats.dispatch_sizes = (g.m_pad,)
        else:
            forest_fn = self.spec.build_forest_finish()
            fu, fv = self._backend.amsf(
                g, weights, app, forest_fn,
                compress=self.spec.forest_compress, stats=stats)
            edges = _amsf_impl.forest_edges(fu, fv)
        self._stats = stats
        if return_stats:
            return edges, stats
        return edges

    def msf(self, g, weights, **kw) -> np.ndarray:
        """Exact MSF (Borůvka, the GBBS-MSF baseline): ``amsf(g, w,
        "msf")``."""
        return self.amsf(g, weights, "msf", **kw)

    def scan(self, g, sims, spec: AppSpecLike = "scan", *,
             return_stats: bool = False):
        """SCAN clustering via parallel GS*-Query (paper §5.2) → ``(labels,
        is_core)`` on the session's device.

        ``sims`` is the per-directed-edge structural-similarity index
        (``core.apps.scan.build_index``, offline, like GS*-Index). The
        core-core connectivity runs this session's finish method; non-core
        border vertices join the minimum adjacent core cluster; the rest
        keep their own id. Fills ``.stats``."""
        app = as_app_spec(spec)
        if app.app != "scan":
            raise ValueError(
                f"scan() takes a scan spec, got {str(app)!r} "
                f"(amsf/msf run via .amsf(g, weights, spec))")
        self._check_device(g)
        stats = self._app_stats(app, g)
        labels, is_core = self._backend.scan(
            g, torch.as_tensor(sims, device=self.device), app, self._finish,
            stats)
        self._stats = stats
        if return_stats:
            return labels, is_core, stats
        return labels, is_core

    def serve(self, n: Optional[int] = None, *, tenants=None, config=None,
              dynamic: Optional[bool] = None, log: Optional[int] = None,
              search_rounds: int = dyn_engine.DEFAULT_SEARCH_ROUNDS,
              **knobs):
        """Async serving front-end over a live graph (``repro_torch.serve``)
        under this session's placement.

        Returns a not-yet-started ``repro_torch.serve.Server``: an asyncio
        admission layer (``submit_inserts`` / ``query`` coroutines) that
        coalesces concurrent client traffic into batches padded under the
        placement's pad policy, with double-buffered snapshot epochs so that
        queries always read a stable committed snapshot. Pass ``n`` for one
        logical graph, or ``tenants={"name": n, ...}`` to serve several
        tenant namespaces from one shared state. ``config`` is a
        ``repro_torch.serve.ServeConfig``; extra ``knobs``
        (``max_batch_edges=...``, ``flush_ms=...``, ...) override its
        fields.

        With ``dynamic=True`` (or a ``:dynamic`` exec) the server also
        accepts ``submit_deletes``: deletions coalesce into the same commit
        pipeline (a root-based finish is required; ``log`` sizes the
        tombstoned edge log as in ``stream``).

        On a placement over several ranks every rank calls ``serve`` with
        the same arguments: rank 0 gets the ``Server``, every other rank a
        ``repro_torch.serve.Follower``, whose ``run()`` replays rank 0's
        commits until rank 0's ``server.stop_followers()``.

        >>> server = ConnectIt("none+uf_sync_full").serve(1 << 16)
        >>> async with server:
        ...     epoch = await server.submit_inserts(u, v)
        ...     ans, at_epoch = await server.query(qa, qb)
        """
        from .serve import ServeConfig, Server, TenantRegistry
        from .serve.mesh import Follower, channel_for
        registry = TenantRegistry.build(n=n, tenants=tenants)
        cfg = config or ServeConfig()
        if knobs:
            cfg = dataclasses.replace(cfg, **knobs)
        dyn = self.exec.dynamic if dynamic is None else bool(dynamic)
        if dyn:
            if not self.spec.forest_capable:
                raise ValueError(
                    f"dynamic serving needs a root-based finish "
                    f"({'/'.join(FOREST_METHODS)}), not "
                    f"{self.spec.finish_str!r} — paper §3.4")
            cap = self.exec.log if log is None else log
            if cap and cap & (cap - 1):
                raise ValueError(f"log must be a power of two, got {cap}")
            ops = self._backend.dynamic_snapshot_ops(
                registry.total, compress=self.spec.forest_compress, log=cap,
                search_rounds=search_rounds, donate=cfg.donate)
        else:
            if log:
                raise ValueError("log= is a dynamic-serving knob — pass "
                                 "dynamic=True (or use a ':dynamic' exec)")
            ops = self._backend.snapshot_ops(registry.total, self._finish,
                                             donate=cfg.donate)
        channel = channel_for(self._backend)
        if channel is not None and not channel.leader:
            return Follower(ops, registry.total, channel)
        return Server(ops, registry, config=cfg, variant=str(self.spec),
                      exec_str=str(self.exec),
                      devices=self._backend.devices, channel=channel)
