"""ConnectIt finish methods (paper §3.3): the synchronous union-find family.

Every finish method has the signature::

    finish(P, senders, receivers) -> (P, rounds)

on a ``(n + 1,)`` label tensor (see primitives.py) and padded COO edge
tensors (padded edges point at the dump slot ``n``). ``uf_sync`` is
min-based (labels only decrease) and tolerates the ``-1`` virtual-minimum
label of L_max skipping, so it composes with any sampling scheme.

One uf_sync round is one fused hook+compress call (gather parents →
root-mask → min-hook → shortcut hops), and the paper's find options map onto
the hop count of that call:

    FindNaive   → compress='naive' (one shortcut hop)
    FindHalve   → compress='halve' (two shortcut rounds, chained hops)
    FindCompress→ compress='full'  (the same call, then jumps to fixpoint)
"""

from __future__ import annotations

from typing import Callable

from .primitives import (
    DEFAULT_MAX_ROUNDS,
    full_compress,
    hook_compress,
    iterate_to_fixpoint,
)

FinishFn = Callable[..., tuple]

COMPRESS_MODES = ("naive", "halve", "full")
METHODS = ("uf_sync",)

# shortcut hops fused into the hook+compress call per compress mode: k
# chained hops compose as H^(k+1), so k=3 ≡ two P←P[P] rounds (halve);
# 'full' runs the same fused call, then pointer-jumps to fixpoint
_HOOK_JUMPS = {"naive": 1, "halve": 3, "full": 3}


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


_FINISHES: dict = {}  # (method, compress) -> finish callable


def make_finish(method: str, *, compress: str = "naive") -> FinishFn:
    """The memoized finish callable of one parameterization."""
    if method not in METHODS:
        raise NotImplementedError(
            f"finish method {method!r} is not ported yet (ROADMAP Queue 1 "
            f"item 6); have {METHODS}")
    key = (method, compress)
    if key not in _FINISHES:
        _FINISHES[key] = make_uf_sync(compress)
    return _FINISHES[key]
