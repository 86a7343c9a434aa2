"""ExecutionSpec: where and how a ConnectIt session dispatches.

``repro_torch.api.VariantSpec`` says *what* to run; ``ExecutionSpec`` says
*where*. The grammar is the JAX package's (``repro/core/execution.py``),
and canonical strings round-trip, ``ExecutionSpec.parse(str(s)) == s``:

    placement := single | replicated | sharded
    exec      := placement [ "(" axes ")" ] [ ":" opt ("," opt)* ]
    axes      := axis ("," axis)* [ "|" label_axis ]      # sharded only
    opt       := "fused" | "overlap" | "donate"
               | "frontier=" INT | "pad=" ("pow2" | INT) | "rounds=" INT
               | "dynamic" | "log=" INT | "tune"
               | "kernels=" ("auto" | "pallas" | "interpret" | "ref")

    single                     one device, compacted finish dispatch
    single:fused               one device, no compaction
    replicated(x)              edges split over x, labels whole per rank
    sharded(x)                 edges AND labels split over x
    sharded(x,y)               edges over x×y, labels over y
    sharded(pod,data|model)    edges over pod×data, labels over model
    sharded(x):fused           min-reduce-scatter dense merge
    sharded(x):frontier=1024   compacted merge capped at 1024 ids per rank
    sharded(x):overlap         double-buffered merge

Knobs a placement does not use are pinned to their defaults, so equality
and round-trips are canonical, as in the reference. A placement's mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks, ranks
row-major as JAX orders devices (``plan_mesh``); every rank makes the same
session call and the ranks meet in collectives (``core/distributed.py``).

One knob parses but does not run here: ``kernels=`` other than ``auto``
(the port dispatches by tensor device, with no policy knob);
``repro_torch.api.ConnectIt`` refuses a session with it. ``tune`` makes an
``"auto"`` session measure its variant (``repro_torch.tune``). ``donate`` is
accepted and changes nothing on the finish programs: no program keeps the
caller's label buffer past its first round (serving reads it, per call).

A session plans its backend once (``make_backend``); the meshes are
memoized per process group (``make_axis_mesh``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..dynamic import engine as dyn_engine
from ..graphs.containers import round_up
from ..kernels.index import take
from . import collectives as coll
from . import driver, streaming
from .apps import amsf as amsf_impl
from .apps import scan as scan_impl
from .distributed import (
    StreamPrograms,
    make_replicated_amsf,
    make_replicated_dynamic,
    make_replicated_finish,
    make_replicated_stream,
    make_sharded_amsf,
    make_sharded_dynamic,
    make_sharded_finish,
    make_sharded_stream,
)
from .primitives import (
    INT_MAX,
    canonical_labels,
    init_forest,
    init_labels,
    num_components,
)

__all__ = ["ExecutionSpec", "PLACEMENTS", "KERNEL_POLICIES", "make_backend",
           "plan_mesh", "make_axis_mesh", "bucket_size",
           "as_execution_spec", "ShardedEpoch", "served_labels"]

PLACEMENTS = ("single", "replicated", "sharded")
PAD_POLICIES = ("pow2", "multiple")
# the reference's policies parse and round-trip; only "auto" runs here
KERNEL_POLICIES = ("auto", "pallas", "interpret", "ref")

_AXIS_RE = re.compile(r"[a-z][a-z0-9_]*")
_HEAD_RE = re.compile(r"([a-z_]+)(?:\((.*)\))?")

# pinned defaults per placement; the one source of canonicalization
_PINNED = {
    "single": ("axes", "label_axis", "donate", "rounds", "frontier",
               "overlap"),
    "replicated": ("label_axis", "fused", "frontier", "overlap"),
    "sharded": (),
}
_EXEC_DEFAULTS: dict = {}


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """Declarative execution configuration (placement + dispatch policy)."""

    placement: str = "single"
    axes: tuple = ()            # mesh axes carrying edges
    label_axis: str = ""        # sharded: mesh axis carrying labels
    fused: bool = False
    frontier: int = -1          # sharded merge: -1 auto | 0 dense | N cap
    overlap: bool = False       # sharded: double-buffered merge/compute
    pad: str = "pow2"           # dispatch-shape bucketing policy
    pad_multiple: int = 8       # pad="multiple": granularity
    donate: bool = False
    rounds: int = 0             # distributed outer rounds; 0 = fixpoint
    dynamic: bool = False       # mixed insert/delete/query streams
    log: int = 0                # dynamic edge-log capacity; 0 = auto
    tune: bool = False          # force re-tuning of auto selections
    kernels: str = "auto"       # the reference's KernelPolicy

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r}; "
                             f"have {PLACEMENTS}")
        if self.kernels not in KERNEL_POLICIES:
            raise ValueError(f"unknown kernel policy {self.kernels!r}; "
                             f"have {KERNEL_POLICIES}")
        object.__setattr__(self, "axes", tuple(self.axes))
        for name in ("pad_multiple", "rounds", "log", "frontier"):
            v = getattr(self, name)
            if int(v) != v:
                raise ValueError(f"{name} must be an integer, got {v!r}")
            object.__setattr__(self, name, int(v))
        if self.frontier < -1:
            raise ValueError(
                f"frontier must be -1 (auto), 0 (dense), or a positive "
                f"per-device cap, got {self.frontier}")
        if self.pad not in PAD_POLICIES:
            raise ValueError(f"unknown pad policy {self.pad!r}; have "
                             f"{PAD_POLICIES} (or pad=<int> in spec strings)")
        if self.pad_multiple < 1:
            raise ValueError(f"pad_multiple must be >= 1, "
                             f"got {self.pad_multiple}")
        if self.rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {self.rounds}")
        if self.log and not self.dynamic:
            raise ValueError(
                f"log={self.log} requires the dynamic opt (the edge log "
                "only exists on dynamic streams)")
        if self.log < 0 or (self.log and self.log & (self.log - 1)):
            raise ValueError(
                f"log must be a power of two (dispatch-shape discipline), "
                f"got {self.log}")
        if self.placement != "single":
            axes = self.axes or ("x",)
            for a in axes:
                if not _AXIS_RE.fullmatch(a):
                    raise ValueError(f"bad mesh axis name {a!r}")
            if len(set(axes)) != len(axes):
                raise ValueError(f"duplicate mesh axes in {axes}")
            object.__setattr__(self, "axes", tuple(axes))
        if self.placement == "sharded":
            lab = self.label_axis or self.axes[-1]
            if not _AXIS_RE.fullmatch(lab):
                raise ValueError(f"bad label axis name {lab!r}")
            object.__setattr__(self, "label_axis", lab)
        for name in _PINNED[self.placement]:
            object.__setattr__(self, name, _EXEC_DEFAULTS[name])
        if self.pad == "pow2":
            object.__setattr__(self, "pad_multiple",
                               _EXEC_DEFAULTS["pad_multiple"])

    @property
    def mesh_axes(self) -> tuple:
        """All mesh axis names this placement needs, in mesh order."""
        if self.placement == "single":
            return ()
        if self.placement == "replicated":
            return self.axes
        return tuple(dict.fromkeys(self.axes + (self.label_axis,)))

    def __str__(self) -> str:
        if self.placement == "single":
            head = "single"
        elif self.placement == "replicated":
            head = f"replicated({','.join(self.axes)})"
        elif self.axes and self.label_axis == self.axes[-1]:
            # canonical no-bar form: the last edge axis carries the labels
            head = f"sharded({','.join(self.axes)})"
        else:
            head = f"sharded({','.join(self.axes)}|{self.label_axis})"
        opts = []
        if self.fused:
            opts.append("fused")
        if self.overlap:
            opts.append("overlap")
        if self.frontier != -1:
            opts.append(f"frontier={self.frontier}")
        if self.pad == "multiple":
            opts.append(f"pad={self.pad_multiple}")
        if self.donate:
            opts.append("donate")
        if self.rounds:
            opts.append(f"rounds={self.rounds}")
        if self.dynamic:
            opts.append("dynamic")
        if self.log:
            opts.append(f"log={self.log}")
        if self.tune:
            opts.append("tune")
        if self.kernels != "auto":
            opts.append(f"kernels={self.kernels}")
        return head + (":" + ",".join(opts) if opts else "")

    @classmethod
    def parse(cls, text: str) -> "ExecutionSpec":
        t = text.strip()
        head, _, optpart = t.partition(":")
        m = _HEAD_RE.fullmatch(head.strip())
        if not m:
            raise ValueError(f"bad execution spec {text!r}")
        placement, axespart = m.group(1), m.group(2)
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r} in {text!r}; "
                             f"have {PLACEMENTS}")
        kw: dict = {}
        if axespart is not None:
            if placement == "single":
                raise ValueError(
                    f"placement 'single' takes no mesh axes: {text!r}")
            if not axespart.strip():
                raise ValueError(f"empty mesh axis list in {text!r}")
            epart, bar, lpart = axespart.partition("|")
            names = tuple(a.strip() for a in epart.split(","))
            if bar:
                if placement != "sharded":
                    raise ValueError(
                        f"'|label_axis' is only valid for sharded: {text!r}")
                kw["axes"] = names
                kw["label_axis"] = lpart.strip()
            elif placement == "sharded":
                # without '|': edges over every listed axis, labels over the
                # last (sharded(x) is the 1-D mesh, sharded(x,y) the 2-D)
                kw["label_axis"] = names[-1]
                kw["axes"] = names
            else:
                kw["axes"] = names
        for opt in filter(None, (o.strip() for o in optpart.split(","))):
            key, eq, val = opt.partition("=")
            if key == "fused" and not eq:
                kw["fused"] = True
            elif key == "overlap" and not eq:
                kw["overlap"] = True
            elif key == "frontier" and eq:
                kw["frontier"] = int(val)
            elif key == "donate" and not eq:
                kw["donate"] = True
            elif key == "rounds" and eq:
                kw["rounds"] = int(val)
            elif key == "dynamic" and not eq:
                kw["dynamic"] = True
            elif key == "log" and eq:
                kw["log"] = int(val)
            elif key == "tune" and not eq:
                kw["tune"] = True
            elif key == "kernels" and eq:
                kw["kernels"] = val.strip()
            elif key == "pad" and eq:
                if val == "pow2":
                    kw["pad"] = "pow2"
                else:
                    kw["pad"] = "multiple"
                    kw["pad_multiple"] = int(val)
            else:
                raise ValueError(f"bad execution option {opt!r} in {text!r}")
        return cls(placement=placement, **kw)


_EXEC_DEFAULTS.update({
    f.name: f.default for f in dataclasses.fields(ExecutionSpec)
    if f.name != "placement"
})


def as_execution_spec(exec) -> ExecutionSpec:  # noqa: A002 - mirrors the API
    if isinstance(exec, str):
        return ExecutionSpec.parse(exec)
    if isinstance(exec, ExecutionSpec):
        return exec
    raise TypeError(f"exec must be an ExecutionSpec or string, "
                    f"got {type(exec).__name__}")


# ---------------------------------------------------------------------------
# Mesh planning.
# ---------------------------------------------------------------------------

def _balanced_factors(ndev: int, naxes: int) -> tuple:
    """Split ``ndev`` into ``naxes`` integer factors, as balanced as the
    prime factorization allows (8, 3 → (2, 2, 2); 12, 2 → (4, 3))."""
    primes = []
    d, k = 2, ndev
    while d * d <= k:
        while k % d == 0:
            primes.append(d)
            k //= d
        d += 1
    if k > 1:
        primes.append(k)
    sizes = [1] * naxes
    for p in sorted(primes, reverse=True):
        sizes[int(np.argmin(sizes))] *= p
    return tuple(sorted(sizes, reverse=True))


# planned meshes per (axis names, device type), for the world they were
# built in: building one makes a process group per axis, a collective of
# every rank
_MESHES: dict = {}


def make_axis_mesh(axis_names: Sequence[str], device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the world with the rank count
    factored as evenly as possible across ``axis_names``, ranks row-major.
    The process group must exist (``repro_torch.launch.multihost.initialize``;
    ``repro_torch.api.ConnectIt`` makes one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh placement needs a torch.distributed process group: call "
            "repro_torch.launch.multihost.initialize() first")
    world = dist.group.WORLD
    if _MESHES.get("world") is not world:  # a new group: forget the old
        _MESHES.clear()
        _MESHES["world"] = world
    key = (tuple(axis_names), device_type)
    if key not in _MESHES:
        sizes = _balanced_factors(dist.get_world_size(), len(key[0]))
        _MESHES[key] = init_device_mesh(device_type, sizes,
                                        mesh_dim_names=key[0])
    return _MESHES[key]


def plan_mesh(spec: ExecutionSpec, mesh=None, device_type: str = "cuda"):
    """The mesh of a spec: a user's mesh, checked for the spec's axes, or
    one built over every rank; ``None`` for ``single``."""
    names = spec.mesh_axes
    if not names:
        return None
    if mesh is not None:
        have = tuple(mesh.mesh_dim_names or ())
        missing = [a for a in names if a not in have]
        if missing:
            raise ValueError(
                f"mesh axes {have} do not provide {missing} "
                f"required by {str(spec)!r}")
        if mesh.device_type != device_type:
            raise ValueError(f"mesh on {mesh.device_type!r} devices, "
                             f"session on {device_type!r}")
        return mesh
    return make_axis_mesh(names, device_type)


# ---------------------------------------------------------------------------
# Dispatch-shape bucketing (pad policy).
# ---------------------------------------------------------------------------

# one pad-policy definition (driver.py)
bucket_size = driver.bucket_size
_per_chunk_counts = driver._per_chunk_counts


def _pad_edges(s: torch.Tensor, r: torch.Tensor, dump: int, size: int):
    out_s = s.new_full((size,), dump)
    out_r = r.new_full((size,), dump)
    out_s[: s.shape[0]] = s
    out_r[: r.shape[0]] = r
    return out_s, out_r


def _resize_device_edges(arrs: tuple, fills: tuple, size: int) -> tuple:
    """Resize edge-aligned arrays to a dispatch ``size`` on their device:
    grow with sentinel tails, or drop tail padding (the real entries hold
    the first ``min(size, len)`` slots)."""
    m = int(arrs[0].shape[0])
    if size > m:
        return tuple(torch.cat([a, a.new_full((size - m,), fill)])
                     for a, fill in zip(arrs, fills))
    if size < m:
        return tuple(a[:size] for a in arrs)
    return arrs


# ---------------------------------------------------------------------------
# Application helpers shared by the backends (paper §5).
# ---------------------------------------------------------------------------

def _fill_amsf_stats(stats, nb, rounds, counts, *, size: int, m_real: int,
                     shards: int) -> None:
    """The AMSF fields of ConnectivityStats after a masked sweep.

    ``edges_finish`` counts finite-weight real edges (each in exactly one
    bucket); every bucket scatters the full ``size`` list once, hence
    ``edges_finish_padded = buckets * size``."""
    nb = int(nb)
    counts = counts.cpu().numpy()
    stats.buckets = nb
    stats.finish_rounds = int(rounds)
    stats.edges_per_bucket = tuple(
        int(c) for c in counts[: min(nb, counts.shape[0])])
    stats.edges_finish = int(counts.sum())
    stats.edges_finish_padded = nb * size
    stats.edges_per_device = _per_chunk_counts(min(m_real, size), size,
                                               shards)
    stats.dispatch_sizes = (size // shards,) * shards


def _amsf_coo_host(g, weights, app, forest_fn, stats):
    """AMSF-COO: the host's bucket compaction is a single-device loop under
    every placement, as in the reference (the spanning-forest precedent);
    each bucket's dispatch is padded to a power of two."""
    _, fu, fv, nb, rounds, counts, sizes = amsf_impl.amsf_coo_run(
        g, weights, eps=app.eps, forest_fn=forest_fn)
    cap = amsf_impl.STATS_BUCKET_CAP
    if len(counts) > cap:  # fold the overflow as the device histogram does
        counts = counts[: cap - 1] + [sum(counts[cap - 1:])]
    stats.buckets = nb
    stats.finish_rounds = rounds
    stats.edges_per_bucket = tuple(counts)
    stats.edges_finish = sum(counts)
    stats.edges_finish_padded = sum(sizes)
    stats.edges_per_device = (sum(counts),)
    stats.dispatch_sizes = tuple(sizes)
    return fu, fv


# ---------------------------------------------------------------------------
# Served state.
# ---------------------------------------------------------------------------

class ShardedEpoch(NamedTuple):
    """A served epoch under the sharded placement: this rank's state (its
    label window, or a ``DynamicState`` whose ``P`` is the window) and the
    epoch's whole labels ``P``, gathered once at the end of the commit that
    made the epoch. Queries read ``P`` and enter no collective, so only
    commits do (serve/mesh.py)."""

    state: Any
    P: torch.Tensor


def served_labels(state) -> torch.Tensor:
    """The whole labels of a served epoch, read with no collective: a raw
    label buffer, or the ``P`` of a ``DynamicState`` or a
    ``ShardedEpoch``."""
    return state if isinstance(state, torch.Tensor) else state.P


def _served_query(state, qa, qb) -> torch.Tensor:
    P = served_labels(state)
    return take(P, qa) == take(P, qb)


# ---------------------------------------------------------------------------
# Backends.
# ---------------------------------------------------------------------------

class _Backend:
    """Shared planning state: one backend per (ExecutionSpec, mesh,
    device)."""

    def __init__(self, spec: ExecutionSpec, mesh=None, *, device):
        self.spec = spec
        self.device = torch.device(device)
        self.mesh = plan_mesh(spec, mesh, self.device.type)

    @property
    def devices(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.size())

    @property
    def edge_shards(self) -> int:
        if self.mesh is None:
            return 1
        return coll.mesh_size(self.mesh, self.spec.axes)

    def _bucket(self, k: int) -> int:
        return bucket_size(k, pad=self.spec.pad,
                           pad_multiple=self.spec.pad_multiple,
                           shards=self.edge_shards)

    def _delete_bucket(self, k: int) -> int:
        # delete batches are whole on every rank (each rank tombstones its
        # own log slots), so no shard-multiple constraint
        return bucket_size(k, pad=self.spec.pad,
                           pad_multiple=self.spec.pad_multiple, shards=1)

    def _log_cap(self, n: int, log: int) -> int:
        cap = log or self.spec.log or dyn_engine.default_log_cap(n)
        return round_up(cap, self.edge_shards)

    def _donate(self, donate: Optional[bool]) -> bool:
        # an override, not spec.donate: single pins donate=False for the
        # finish, but the serve rotation may drop its shadow on any placement
        return bool(donate) if donate is not None else self.spec.donate

    def _base_stats(self, variant: str) -> driver.ConnectivityStats:
        return driver.ConnectivityStats(
            variant=variant, exec=str(self.spec),
            placement=self.spec.placement, devices=self.devices,
            fused=self.spec.fused)

    def spanning_forest(self, g, sampler_fn, rng=None, *,
                        compress: str = "full", variant: str = ""):
        # the single-device driver under every placement, as in the
        # reference: a recorded spanning forest of a static graph needs a
        # tie-break across ranks per round, which only AMSF and the dynamic
        # programs pay for (core/distributed.py)
        return driver.run_spanning_forest(
            g, sampler_fn, rng, compress=compress, variant=variant,
            compact_pad=self.spec.pad_multiple, pad=self.spec.pad)


class SingleBackend(_Backend):
    """One device: the two-phase driver (compacted or fused)."""

    placement = "single"

    def connectivity(self, g, sampler_fn, finish_fn, rng=None, *,
                     variant: str = "", fused: Optional[bool] = None):
        fused = self.spec.fused if fused is None else fused
        if fused:
            labels, stats = driver.run_connectivity_fused(
                g, sampler_fn, finish_fn, rng, variant=variant)
        else:
            labels, stats = driver.run_connectivity(
                g, sampler_fn, finish_fn, rng, variant=variant,
                compact_pad=self.spec.pad_multiple, pad=self.spec.pad)
        # the spec that ran: a per-call fused override shows in stats.exec
        stats.exec = str(dataclasses.replace(self.spec, fused=fused))
        return labels, stats

    def stream_ops(self, n: int, finish_fn) -> streaming.StreamOps:
        ops = streaming.stream_ops(n, finish_fn, device=self.device)
        return ops._replace(batch_size=self._bucket)

    def snapshot_ops(self, n: int, finish_fn, *,
                     donate: Optional[bool] = None) -> streaming.SnapshotOps:
        ops = streaming.snapshot_ops(n, finish_fn, device=self.device,
                                     donate=self._donate(donate))
        return ops._replace(batch_size=self._bucket)

    # -- batch-dynamic (repro_torch.dynamic) ----------------------------------

    def dynamic_ops(self, n: int, *, compress: str = "full", log: int = 0,
                    search_rounds: int = dyn_engine.DEFAULT_SEARCH_ROUNDS
                    ) -> dyn_engine.DynamicOps:
        ops = dyn_engine.dynamic_ops(
            n, device=self.device, compress=compress,
            log=self._log_cap(n, log), search_rounds=search_rounds)
        return ops._replace(batch_size=self._bucket,
                            delete_size=self._delete_bucket)

    def dynamic_snapshot_ops(self, n: int, *, compress: str = "full",
                             log: int = 0,
                             search_rounds: int =
                             dyn_engine.DEFAULT_SEARCH_ROUNDS,
                             donate: Optional[bool] = None
                             ) -> dyn_engine.DynamicSnapshotOps:
        ops = dyn_engine.dynamic_snapshot_ops(
            n, device=self.device, compress=compress,
            log=self._log_cap(n, log), search_rounds=search_rounds,
            donate=self._donate(donate))
        return ops._replace(batch_size=self._bucket,
                            delete_size=self._delete_bucket)

    # -- applications (paper §5) ------------------------------------------------

    def amsf(self, g, weights, app, forest_fn, *, compress: str, stats):
        if app.mode == "coo":
            return _amsf_coo_host(g, weights, app, forest_fn, stats)
        P0 = init_labels(g.n, device=g.device)
        fu0, fv0 = init_forest(g.n, device=g.device)
        _, fu, fv, nb, rounds, counts = amsf_impl.amsf_device(
            P0, fu0, fv0, g.senders, g.receivers, weights,
            eps=app.eps, skip=(app.skip == "lmax"), forest_fn=forest_fn)
        _fill_amsf_stats(stats, nb, rounds, counts, size=g.m_pad,
                         m_real=g.m, shards=1)
        return fu, fv

    def scan(self, g, sims, app, finish_fn, stats):
        labels, is_core, rounds, edges_core = scan_impl.gs_query_device(
            g.senders, g.receivers, g.edge_mask, sims, eps=app.eps,
            mu=app.mu, finish_fn=finish_fn, n=g.n)
        stats.finish_rounds = int(rounds)
        stats.edges_finish = int(edges_core)
        stats.edges_finish_padded = g.m_pad
        stats.edges_per_device = (int(edges_core),)
        stats.dispatch_sizes = (g.m_pad,)
        return labels, is_core


class _MeshBackend(_Backend):
    """Shared distributed machinery: edge placement, the finish, stream,
    dynamic and AMSF programs, the served epochs, canonicalization. Every
    rank holds the whole graph and takes its own blocks."""

    def _edge_block(self, *arrs):
        """This rank's block of each padded edge-aligned array: block ``i``
        of ``P(axes)``, ``[i·size/S, (i+1)·size/S)``."""
        i = coll.shard_index(self.mesh, self.spec.axes)
        per = arrs[0].shape[0] // self.edge_shards
        return tuple(a[i * per: (i + 1) * per] for a in arrs)

    def finish_program(self, finish_fn):
        """The raw ``(labels, senders, receivers) -> (labels, rounds)``
        program on this rank's blocks (``connectivity`` is the session
        path)."""
        return self._build_finish(finish_fn)

    def stream_programs(self, finish_fn) -> StreamPrograms:
        """The raw insert, query and process programs on this rank's
        blocks (``stream_ops`` is the session path)."""
        return self._build_stream(finish_fn)

    def _prep_edges(self, g, sampler_fn, rng, stats):
        """Sampling phase + compaction + shard-even padding, the same on
        every rank. Without sampling there is nothing to compact, and the
        graph's arrays are resized (pad slots carry the dump id ``n``)."""
        if sampler_fn is None:
            P0 = init_labels(g.n, device=g.device)
            kept = g.m
            size = self._bucket(kept)
            senders, receivers = _resize_device_edges(
                (g.senders, g.receivers), (g.n, g.n), size)
        else:
            P0 = sampler_fn(g, driver._default_rng(g, rng))
            P0, keep, _, cnt = driver._prep_sampled(P0, g.senders,
                                                    g.receivers)
            s, r = g.senders[keep], g.receivers[keep]
            stats.lmax_count = int(cnt)
            kept = int(s.shape[0])
            size = self._bucket(kept)
            senders, receivers = _pad_edges(s, r, g.n, size)
        stats.edges_finish = kept
        stats.edges_finish_padded = size
        shards = self.edge_shards
        stats.edges_per_device = _per_chunk_counts(kept, size, shards)
        stats.dispatch_sizes = (size // shards,) * shards
        return P0, senders, receivers

    def connectivity(self, g, sampler_fn, finish_fn, rng=None, *,
                     variant: str = "", fused: Optional[bool] = None):
        if fused is not None and fused != self.spec.fused:
            if self.spec.placement == "replicated":
                raise ValueError(
                    "the replicated placement has no fused variant (its "
                    "merge is already a single pmin); drop the fused "
                    "override or use a sharded placement")
            want = dataclasses.replace(self.spec, fused=fused)
            raise ValueError(
                "fused is part of the ExecutionSpec for distributed "
                f"placements — build the session with exec={str(want)!r} "
                "instead of overriding per call")
        stats = self._base_stats(variant)
        stats.edges_total = g.m
        P0, senders, receivers = self._prep_edges(g, sampler_fn, rng,
                                                  stats)
        program = self.finish_program(finish_fn)
        labels, rounds = program(self._place_labels(P0),
                                 *self._edge_block(senders, receivers))
        stats.finish_rounds = int(rounds)
        labels = canonical_labels(self._full_labels(labels)[: g.n + 1])
        return labels[: g.n], stats

    def stream_ops(self, n: int, finish_fn) -> streaming.StreamOps:
        progs = self.stream_programs(finish_fn)

        def insert(state, u, v):
            return progs.insert(state, *self._edge_block(u, v))

        def process(state, u, v, qa, qb):
            return progs.process(state, *self._edge_block(u, v), qa, qb)

        return streaming.StreamOps(
            init=lambda: self._place_labels(init_labels(n,
                                                        device=self.device)),
            insert=insert,
            process=process,
            query=progs.query,
            labels=lambda state: self._full_labels(state)[:n],
            ncomp=lambda state: num_components(
                self._full_labels(state)[: n + 1]),
            edge_shards=self.edge_shards,
            batch_size=self._bucket,
        )

    # -- served epochs (repro_torch.serve) --------------------------------------
    #
    # A commit is the placement's program on this rank's blocks; the epoch
    # it makes carries whole labels (``_epoch``), so that a query enters no
    # collective. Every rank runs every commit (serve/mesh.py).

    def _epoch(self, state, full=None):
        """The served epoch of a placed state (``full``: its whole labels
        where they are known without a collective)."""
        return state

    def _placed(self, epoch):
        """The placed state of a served epoch."""
        return epoch

    def snapshot_ops(self, n: int, finish_fn, *,
                     donate: Optional[bool] = None) -> streaming.SnapshotOps:
        progs = self._build_stream(finish_fn)

        def commit(committed, shadow, u, v):
            del shadow  # every op writes out of place; the shadow is dead
            labels, rounds = progs.insert(self._placed(committed),
                                          *self._edge_block(u, v))
            return self._epoch(labels), rounds

        def init():
            P0 = init_labels(n, device=self.device)
            return self._epoch(self._place_labels(P0),
                               self._pad_labels(P0))

        return streaming.SnapshotOps(
            init=init,
            commit=commit,
            query=_served_query,
            labels=lambda st: served_labels(st)[:n],
            ncomp=lambda st: num_components(served_labels(st)[: n + 1]),
            edge_shards=self.edge_shards,
            batch_size=self._bucket,
            device=self.device,
            donate=self._donate(donate),
        )

    # -- batch-dynamic (repro_torch.dynamic) ------------------------------------

    def _init_dynamic_state(self, n: int, cap: int):
        """Labels placed, the forest whole, this rank's block of the log."""
        st = dyn_engine.init_dynamic(n, cap, device=self.device)
        log_u, log_v = self._edge_block(st.log_u, st.log_v)
        return dyn_engine.DynamicState(self._place_labels(st.P), st.fu,
                                       st.fv, log_u.clone(), log_v.clone())

    def _dynamic_programs(self, n: int, compress: str, search_rounds: int):
        progs = self._build_dynamic(n, compress=compress,
                                    search_rounds=search_rounds)

        def raw_update(state, du, dv, u, v):
            out = progs.update(*state, du, dv, *self._edge_block(u, v))
            return dyn_engine.DynamicState(*out[:5]), out[5]

        return progs, raw_update

    def dynamic_ops(self, n: int, *, compress: str = "full", log: int = 0,
                    search_rounds: int = dyn_engine.DEFAULT_SEARCH_ROUNDS
                    ) -> dyn_engine.DynamicOps:
        cap = self._log_cap(n, log)
        progs, raw_update = self._dynamic_programs(n, compress,
                                                   search_rounds)

        def update(state, du, dv, u, v, qa, qb):
            state, rounds = raw_update(state, du, dv, u, v)
            return state, progs.query(state.P, qa, qb), rounds

        return dyn_engine.DynamicOps(
            init=lambda: self._init_dynamic_state(n, cap),
            update=update,
            query=lambda st, qa, qb: progs.query(st.P, qa, qb),
            labels=lambda st: self._full_labels(st.P)[:n],
            ncomp=lambda st: num_components(
                self._full_labels(st.P)[: n + 1]),
            used=lambda st: progs.used(st.log_u),
            forest=lambda st: (st.fu, st.fv),
            edge_shards=self.edge_shards,
            batch_size=self._bucket,
            delete_size=self._delete_bucket,
            log_cap=cap,
        )

    def dynamic_snapshot_ops(self, n: int, *, compress: str = "full",
                             log: int = 0,
                             search_rounds: int =
                             dyn_engine.DEFAULT_SEARCH_ROUNDS,
                             donate: Optional[bool] = None
                             ) -> dyn_engine.DynamicSnapshotOps:
        cap = self._log_cap(n, log)
        progs, raw_update = self._dynamic_programs(n, compress,
                                                   search_rounds)

        def commit(committed, shadow, du, dv, u, v):
            del shadow  # every op writes out of place; the shadow is dead
            state, rounds = raw_update(self._placed(committed), du, dv, u, v)
            return self._epoch(state), rounds

        def init():
            st = self._init_dynamic_state(n, cap)
            return self._epoch(st, self._pad_labels(
                init_labels(n, device=self.device)))

        return dyn_engine.DynamicSnapshotOps(
            init=init,
            commit=commit,
            query=_served_query,
            labels=lambda st: served_labels(st)[:n],
            ncomp=lambda st: num_components(served_labels(st)[: n + 1]),
            used=lambda st: progs.used(self._placed(st).log_u),
            edge_shards=self.edge_shards,
            batch_size=self._bucket,
            delete_size=self._delete_bucket,
            log_cap=cap,
            device=self.device,
            donate=self._donate(donate),
        )

    # -- applications (paper §5) ------------------------------------------------

    def amsf(self, g, weights, app, forest_fn, *, compress: str, stats):
        if app.mode == "coo":
            return _amsf_coo_host(g, weights, app, forest_fn, stats)
        size = self._bucket(g.m)
        senders, receivers = _resize_device_edges(
            (g.senders, g.receivers), (g.n, g.n), size)
        bids = amsf_impl.bucket_ids(weights, app.eps)
        (bids,) = _resize_device_edges((bids,), (INT_MAX,), size)
        bids = torch.where(senders < g.n, bids, INT_MAX)
        counts = amsf_impl.bucket_histogram(bids)
        P0 = init_labels(g.n, device=g.device)
        # the forest buffers span the whole (padded) label array
        fu0 = torch.full((self._pad_labels(P0).shape[0],), -1,
                         dtype=torch.int32, device=g.device)
        program = self._build_amsf(compress=compress,
                                   skip=(app.skip == "lmax"))
        _, fu, fv, nb, rounds = program(
            self._place_labels(P0), fu0, fu0.clone(),
            *self._edge_block(senders, receivers, bids))
        _fill_amsf_stats(stats, nb, rounds, counts, size=size, m_real=g.m,
                         shards=self.edge_shards)
        return fu, fv

    def scan(self, g, sims, app, finish_fn, stats):
        s, r, is_core, core_pad, similar, edges_core = scan_impl.scan_pre(
            g.senders, g.receivers, g.edge_mask, sims, eps=app.eps,
            mu=app.mu, n=g.n)
        size = self._bucket(g.m)
        s, r = _resize_device_edges((s, r), (g.n, g.n), size)
        # the core-core connectivity, the heavy phase, runs the placement's
        # finish program (per-rank finish + min-merge loop)
        program = self.finish_program(finish_fn)
        P, rounds = program(
            self._place_labels(init_labels(g.n, device=g.device)),
            *self._edge_block(s, r))
        labels = scan_impl.scan_attach(self._full_labels(P)[: g.n + 1],
                                       g.senders, g.receivers, core_pad,
                                       similar)
        stats.finish_rounds = int(rounds)
        stats.edges_finish = int(edges_core)
        stats.edges_finish_padded = size
        shards = self.edge_shards
        stats.edges_per_device = tuple(
            (s < g.n).reshape(shards, -1).sum(1).tolist())
        stats.dispatch_sizes = (size // shards,) * shards
        return labels, is_core


class ReplicatedBackend(_MeshBackend):
    """Edges split over every spec axis, labels whole on every rank."""

    placement = "replicated"

    def _build_finish(self, finish_fn):
        return make_replicated_finish(self.mesh, self.spec.axes, finish_fn,
                                      rounds=self.spec.rounds)

    def _build_stream(self, finish_fn):
        return make_replicated_stream(self.mesh, self.spec.axes, finish_fn,
                                      rounds=self.spec.rounds)

    def _build_amsf(self, *, compress: str, skip: bool):
        return make_replicated_amsf(self.mesh, self.spec.axes,
                                    compress=compress, skip=skip)

    def _build_dynamic(self, n: int, *, compress: str, search_rounds: int):
        return make_replicated_dynamic(self.mesh, self.spec.axes, n,
                                       compress=compress,
                                       search_rounds=search_rounds)

    def _pad_labels(self, P0):
        return P0

    def _place_labels(self, P0):
        return P0

    def _full_labels(self, labels):
        return labels


class ShardedBackend(_MeshBackend):
    """Labels split over ``label_axis``: the huge-n regime."""

    placement = "sharded"

    @property
    def label_shards(self) -> int:
        return coll.axis_size(self.mesh, self.spec.label_axis)

    def _build_finish(self, finish_fn):
        return make_sharded_finish(
            self.mesh, self.spec.axes, self.spec.label_axis, finish_fn,
            reduce_scatter=self.spec.fused, rounds=self.spec.rounds,
            frontier=self.spec.frontier, overlap=self.spec.overlap)

    def _build_stream(self, finish_fn):
        return make_sharded_stream(
            self.mesh, self.spec.axes, self.spec.label_axis, finish_fn,
            reduce_scatter=self.spec.fused, rounds=self.spec.rounds,
            frontier=self.spec.frontier, overlap=self.spec.overlap)

    def _build_amsf(self, *, compress: str, skip: bool):
        return make_sharded_amsf(self.mesh, self.spec.axes,
                                 self.spec.label_axis, compress=compress,
                                 skip=skip)

    def _build_dynamic(self, n: int, *, compress: str, search_rounds: int):
        return make_sharded_dynamic(self.mesh, self.spec.axes,
                                    self.spec.label_axis, n,
                                    compress=compress,
                                    search_rounds=search_rounds)

    def _pad_labels(self, P0):
        """``(n + 1,)`` labels padded to a multiple of the label shards; the
        extra slots are self-rooted ids above the dump row, fixed points of
        every finish."""
        n1 = P0.shape[0]
        L = round_up(n1, self.label_shards)
        if L == n1:
            return P0
        tail = torch.arange(n1, L, dtype=P0.dtype, device=P0.device)
        return torch.cat([P0, tail])

    def _place_labels(self, P0):
        """This rank's window of the padded labels."""
        P0 = self._pad_labels(P0)
        per = P0.shape[0] // self.label_shards
        i = coll.axis_index(self.mesh, self.spec.label_axis)
        return P0[i * per: (i + 1) * per].clone()

    def _full_labels(self, shard):
        return coll.all_gather(shard, self.mesh, (self.spec.label_axis,))

    def _epoch(self, state, full=None):
        if full is None:  # the epoch's one gather, at the end of its commit
            window = state if isinstance(state, torch.Tensor) else state.P
            full = self._full_labels(window)
        return ShardedEpoch(state, full)

    def _placed(self, epoch):
        return epoch.state


_PLACEMENT_BACKENDS = {"single": SingleBackend,
                       "replicated": ReplicatedBackend,
                       "sharded": ShardedBackend}


def make_backend(exec="single", mesh=None, *, device="cuda"):  # noqa: A002
    """The backend of a spec on ``device`` (one per session; the mesh it
    plans is memoized)."""
    spec = as_execution_spec(exec)
    return _PLACEMENT_BACKENDS[spec.placement](spec, mesh,
                                               device=torch.device(device))
