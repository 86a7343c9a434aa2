"""ConnectIt finish methods (paper §3.3).

Every finish method has the signature::

    finish(P, senders, receivers) -> (P, rounds)

on a ``(n + 1,)`` label tensor (see primitives.py) and padded COO edge
tensors (padded edges point at the dump slot ``n``). All methods are
min-based (labels only decrease) and tolerate the ``-1`` virtual-minimum
label of L_max skipping, so any of them composes with any sampling scheme.

``make_finish(method, **params)`` maps a method name and its parameters to a
memoized callable::

    make_finish("uf_sync", compress="full")
    make_finish("liu_tarjan", variant="CRFA")

One uf_sync round is one fused hook+compress call (gather parents →
root-mask → min-hook → shortcut hops), and the paper's find options map onto
the hop count of that call:

    FindNaive   → compress='naive' (one shortcut hop)
    FindHalve   → compress='halve' (two shortcut rounds, chained hops)
    FindCompress→ compress='full'  (the same call, then jumps to fixpoint)

Shiloach–Vishkin, the Liu–Tarjan framework, Stergiou and label propagation
are synchronous algorithms already and port rule for rule.

The root-based methods (the uf_sync family and Shiloach–Vishkin) also have a
forest step, ``make_forest_finish(method, **params)``, that records one
spanning-forest edge per hooked root (paper §3.4).
"""

from __future__ import annotations

import inspect
import warnings
from typing import Callable, NamedTuple

import torch

from ..kernels.index import wrap_index
from .primitives import (
    DEFAULT_MAX_ROUNDS,
    full_compress,
    hook_and_record,
    hook_compress,
    init_forest,
    iterate_to_fixpoint,
    jump_round,
    parents_of,
    relabel_round,
    rewrite_edges,
    write_min,
)
from .registry import make_legacy_resolver

FinishFn = Callable[..., tuple]

COMPRESS_MODES = ("naive", "halve", "full")

# shortcut hops fused into the hook+compress call per compress mode: k
# chained hops compose as H^(k+1), so k=3 ≡ two P←P[P] rounds (halve);
# 'full' runs the same fused call, then pointer-jumps to fixpoint
_HOOK_JUMPS = {"naive": 1, "halve": 3, "full": 3}


# ---------------------------------------------------------------------------
# Label propagation (paper B.2.6): frontier-based scatter-min.
# ---------------------------------------------------------------------------

def label_prop(P, senders, receivers, *, max_rounds: int = DEFAULT_MAX_ROUNDS):
    """Its own loop: a round runs while some label changed in the last one
    (the frontier) and fewer than ``max_rounds`` ran; the dump row is never
    in the frontier."""
    n = P.shape[0] - 1
    big = torch.iinfo(P.dtype).max
    s = wrap_index(senders, n + 1)  # the reference's gathers wrap and clamp
    frontier = torch.ones(n + 1, dtype=torch.bool, device=P.device)
    frontier[n] = False
    rounds = 0
    while rounds < max_rounds and bool(frontier.any()):
        act = frontier[s]
        cand = torch.where(act, P[s], big)
        P2 = write_min(P, receivers, cand, act)
        frontier = P2 != P
        P = P2
        rounds += 1
    return P, rounds


# ---------------------------------------------------------------------------
# Shiloach–Vishkin (paper B.2.4): min-hook roots + full compression per round.
# ---------------------------------------------------------------------------

def shiloach_vishkin(P, senders, receivers, *,
                     max_rounds: int = DEFAULT_MAX_ROUNDS):
    def body(P):
        P = hook_compress(P, senders, receivers, jumps=_HOOK_JUMPS["full"])
        return full_compress(P)

    return iterate_to_fixpoint(body, P, max_rounds)


# ---------------------------------------------------------------------------
# UF-Sync family.
# ---------------------------------------------------------------------------

def _compress(P, how: str):
    if how == "naive":
        return jump_round(P)
    if how == "halve":
        return jump_round(P, 3)  # ≡ two P←P[P] rounds
    if how == "full":
        return full_compress(P)
    raise ValueError(how)


def make_uf_sync(compress: str = "naive") -> FinishFn:
    if compress not in COMPRESS_MODES:
        raise ValueError(
            f"unknown compress mode {compress!r}; have {COMPRESS_MODES}")

    def uf_sync(P, senders, receivers, *, max_rounds: int = DEFAULT_MAX_ROUNDS):
        def body(P):
            P = hook_compress(P, senders, receivers,
                              jumps=_HOOK_JUMPS[compress])
            if compress == "full":
                P = full_compress(P)
            return P

        return iterate_to_fixpoint(body, P, max_rounds)

    uf_sync.__name__ = f"uf_sync_{compress}"
    return uf_sync


# ---------------------------------------------------------------------------
# Liu–Tarjan rule framework (paper §3.3.2 + Appendix D.4): 16 valid variants.
# connect ∈ {C: Connect, P: ParentConnect, E: ExtendedConnect}
# root-up ∈ {U: unconditional, R: only roots updated}
# shortcut ∈ {S: one round, F: to fixpoint}
# alter    ∈ {A: rewrite edges to parent ids, -: keep}
# The combinations not listed are the paper's documented-invalid rule mixes
# (Table 1).
# ---------------------------------------------------------------------------

LIU_TARJAN_VARIANTS: dict[str, tuple[str, bool, str, bool]] = {
    # name: (connect, rootup, shortcut, alter)
    "CUSA": ("connect", False, "S", True),
    "CRSA": ("connect", True, "S", True),
    "PUSA": ("parent", False, "S", True),
    "PRSA": ("parent", True, "S", True),
    "PUS": ("parent", False, "S", False),
    "PRS": ("parent", True, "S", False),
    "EUSA": ("extended", False, "S", True),
    "EUS": ("extended", False, "S", False),
    "CUFA": ("connect", False, "F", True),
    "CRFA": ("connect", True, "F", True),
    "PUFA": ("parent", False, "F", True),
    "PRFA": ("parent", True, "F", True),
    "PUF": ("parent", False, "F", False),
    "PRF": ("parent", True, "F", False),
    "EUFA": ("extended", False, "F", True),
    "EUF": ("extended", False, "F", False),
}


def _lt_connect(P, u, v, connect: str, rootup: bool):
    """One connect phase. u/v may be altered labels (possibly -1).

    RootUp ("update the parent value of a vertex iff it is a tree-root at the
    start of the round"): the write target is redirected to the endpoint's
    round-start root, and writes to slots that were not roots at round start
    are masked. The endpoints' parents are gathered only by the rules that
    read them: each gather is a pass over the edge list."""
    P0 = P  # round-start snapshot: all gathers/masks read it

    def put(P, tgt, val):
        if rootup:
            tgt = parents_of(P0, tgt)  # redirect to round-start root
            mask = parents_of(P0, tgt) == tgt
        else:
            mask = None
        return write_min(P, tgt, val, mask)

    if connect == "connect":
        P = put(P, u, v)
        P = put(P, v, u)
    elif connect == "parent":
        if rootup:
            P = put(P, u, parents_of(P0, v))
            P = put(P, v, parents_of(P0, u))
        else:
            # unmasked ParentConnect is exactly one edge-relabel round: both
            # gather-min-scatter directions in one kernel call
            P = relabel_round(P, u, v)
    elif connect == "extended":
        pu = parents_of(P0, u)
        pv = parents_of(P0, v)
        P = put(P, u, pv)
        P = put(P, v, pu)
        P = put(P, pu, pv)
        P = put(P, pv, pu)
    else:
        raise ValueError(connect)
    return P


def make_liu_tarjan(variant: str = "CRFA") -> FinishFn:
    if variant not in LIU_TARJAN_VARIANTS:
        raise ValueError(f"unknown Liu-Tarjan variant {variant!r}; "
                         f"have {sorted(LIU_TARJAN_VARIANTS)}")
    connect, rootup, shortcut, alter = LIU_TARJAN_VARIANTS[variant]
    how = "full" if shortcut == "F" else "naive"

    def liu_tarjan(P, senders, receivers, *,
                   max_rounds: int = DEFAULT_MAX_ROUNDS):
        def step(st):
            P, u, v = st
            P2 = _compress(_lt_connect(P, u, v, connect, rootup), how)
            if alter:
                # altered edges are part of the state: a round that only
                # rewrites endpoints has not converged yet
                u, v = rewrite_edges(P2, u, v)
            return P2, u, v

        st0 = (P, senders.to(P.dtype), receivers.to(P.dtype))
        (P, _, _), rounds = iterate_to_fixpoint(step, st0, max_rounds)
        return P, rounds

    liu_tarjan.__name__ = f"liu_tarjan_{variant}"
    return liu_tarjan


# ---------------------------------------------------------------------------
# Stergiou (paper B.2.5): ParentConnect with a two-array (prev/cur) labeling.
# ---------------------------------------------------------------------------

def stergiou(P, senders, receivers, *, max_rounds: int = DEFAULT_MAX_ROUNDS):
    def step(prev):
        # ParentConnect on the parent-rewritten edges: rewrite endpoints to
        # prev[e], then one edge-relabel round proposes each rewritten
        # endpoint's parent to the other — two kernel calls
        s2, r2 = rewrite_edges(prev, senders, receivers)
        cur = relabel_round(prev, s2, r2)
        return jump_round(cur)

    return iterate_to_fixpoint(step, P, max_rounds)


# ---------------------------------------------------------------------------
# The registry: method name -> factory, memoized per parameterization.
# ---------------------------------------------------------------------------

def memoized_factory(kind: str, factories: dict,
                     error: type = ValueError) -> Callable:
    """``make(name, **params)`` over ``factories``, memoized per
    parameterization. Parameters are normalized with the factory's defaults,
    so ``make("uf_sync")`` and ``make("uf_sync", compress="naive")`` are one
    callable. An unknown name raises ``error``."""
    instances: dict = {}  # (name, normalized params) -> callable

    def make(name: str, **params) -> Callable:
        if name not in factories:
            raise error(f"unknown {kind} {name!r}; "
                        f"have {tuple(sorted(factories))}")
        bound = inspect.signature(factories[name]).bind(**params)
        bound.apply_defaults()
        key = (name, tuple(sorted(bound.arguments.items())))
        if key not in instances:
            instances[key] = factories[name](**bound.arguments)
        return instances[key]

    return make


_FACTORIES: dict = {
    "uf_sync": make_uf_sync,
    "liu_tarjan": make_liu_tarjan,
    "shiloach_vishkin": lambda: shiloach_vishkin,
    "label_prop": lambda: label_prop,
    "stergiou": lambda: stergiou,
}
METHODS = tuple(sorted(_FACTORIES))
# make_finish(method, **params) -> the memoized finish callable
make_finish = memoized_factory("finish method", _FACTORIES)


# ---------------------------------------------------------------------------
# Legacy string-keyed entrypoints (deprecation shims).
#
# The seed exposed one registration per (method, parameter) combination;
# those flat names remain valid through ``get_finish`` (warns) and
# ``resolve_finish`` (silent, for code paths that accept legacy names on
# their own deprecated surface and must not double-warn).
# ---------------------------------------------------------------------------

_LEGACY_FINISH: dict[str, tuple[str, dict]] = {
    "uf_sync": ("uf_sync", {}),  # paper-fastest analogue (FindNaive)
    "uf_sync_naive": ("uf_sync", {"compress": "naive"}),
    "uf_sync_halve": ("uf_sync", {"compress": "halve"}),
    "uf_sync_full": ("uf_sync", {"compress": "full"}),
    "shiloach_vishkin": ("shiloach_vishkin", {}),
    "label_prop": ("label_prop", {}),
    "stergiou": ("stergiou", {}),
    "liu_tarjan": ("liu_tarjan", {}),  # paper-fastest LT variant (CRFA)
}
_LEGACY_FINISH.update({
    f"liu_tarjan_{v}": ("liu_tarjan", {"variant": v})
    for v in LIU_TARJAN_VARIANTS
})

resolve_finish = make_legacy_resolver(_LEGACY_FINISH, make_finish,
                                      "finish method")


def get_finish(name: str) -> FinishFn:
    """Deprecated: use ``make_finish(method, **params)`` or
    ``repro_torch.api``."""
    warnings.warn(
        "get_finish(name) with flat string keys is deprecated; use "
        "make_finish(method, **params) or repro_torch.api.FinishSpec/"
        "VariantSpec",
        DeprecationWarning, stacklevel=2)
    return resolve_finish(name)


def finish_names() -> list[str]:
    """Legacy flat name list (kept for the string-keyed shim surface)."""
    return sorted(_LEGACY_FINISH)


# ---------------------------------------------------------------------------
# Root-based spanning-forest finish (paper §3.4): uf_sync/SV + edge recording.
# Shiloach–Vishkin's round (min-hook roots + full compression) is, with
# recording added, the uf_sync forest round at compress='full'.
# ---------------------------------------------------------------------------

class ForestState(NamedTuple):
    P: torch.Tensor   # (n + 1,) labels
    fu: torch.Tensor  # (n + 1,) forest slots: one edge per hooked root,
    fv: torch.Tensor  # as its original endpoints; -1 = empty


def forest_round(st, s, r, *, compress: str = "full"):
    """One uf_sync hook + compress round that records original endpoints."""
    P, fu, fv = st
    pu = P[s]  # int32 indices: no int64 copy of the edge list a round
    pv = P[r]
    root_u = parents_of(P, pu) == pu
    mask = root_u & (pv < pu)
    P2, fu, fv = hook_and_record(P, pu, pv, mask, s, r, fu, fv)
    return _compress(P2, compress), fu, fv


def _labels_changed(old, new) -> bool:
    # converge on the labels only: the forest buffers can only change in a
    # round whose hooks also decreased a label
    return not torch.equal(old[0], new[0])


def uf_sync_forest(P, senders, receivers, fu=None, fv=None, *,
                   compress: str = "full",
                   max_rounds: int = DEFAULT_MAX_ROUNDS):
    """uf_sync that records one forest edge per hooked root (Theorem 6)
    → (ForestState, rounds)."""
    if fu is None:
        fu, fv = init_forest(P.shape[0] - 1, device=P.device, dtype=P.dtype)
    (P, fu, fv), rounds = iterate_to_fixpoint(
        lambda st: forest_round(st, senders, receivers, compress=compress),
        (P, fu, fv), max_rounds, changed_fn=_labels_changed)
    return ForestState(P, fu, fv), rounds


def make_uf_sync_forest(compress: str = "full") -> FinishFn:
    if compress not in COMPRESS_MODES:
        raise ValueError(
            f"unknown compress mode {compress!r}; have {COMPRESS_MODES}")

    def forest(P, senders, receivers, fu, fv, *,
               max_rounds: int = DEFAULT_MAX_ROUNDS):
        return uf_sync_forest(P, senders, receivers, fu, fv,
                              compress=compress, max_rounds=max_rounds)

    forest.__name__ = f"uf_sync_forest_{compress}"
    return forest


def make_sv_forest() -> FinishFn:
    forest = make_uf_sync_forest("full")  # a fresh closure: rename it
    forest.__name__ = "shiloach_vishkin_forest"
    return forest


_FOREST_FACTORIES: dict = {
    "uf_sync": make_uf_sync_forest,
    "shiloach_vishkin": make_sv_forest,
}
FOREST_METHODS = tuple(_FOREST_FACTORIES)


def forest_method_names() -> list[str]:
    return sorted(_FOREST_FACTORIES)


# make_forest_finish(method, **params) -> the memoized forest step
# ``(P, s, r, fu, fv) -> (ForestState, rounds)``; other methods (label_prop,
# stergiou, liu_tarjan: paper §3.4's restriction) raise KeyError
make_forest_finish = memoized_factory("forest-capable finish method",
                                      _FOREST_FACTORIES, error=KeyError)
