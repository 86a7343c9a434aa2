"""Dispatch layer for the connectivity hot-path kernels.

Every hot-path primitive has two implementations with identical semantics:
a plain PyTorch version (``*/ref.py``) and a CUDA kernel written by hand
(``csrc/*.cu``, wrapped in ``*/kernel.py``). The tensor's device picks one:

    CPU tensor   the plain version
    CUDA tensor  the CUDA kernel; a call it cannot take raises

There is no policy knob and no fallback from the kernel to the plain
version.

This layer owns the contract between core label arrays and the kernels:

  * **dump-slot semantics** — label arrays are ``(n + 1,)`` with dump row
    ``n``; negative / masked / out-of-range scatter targets are dumped onto
    it with the dtype's max sentinel, so the scatter is a no-op whatever the
    target buffer holds;
  * **-1 virtual-minimum fixed points** — the ``-1`` label pinning L_max
    never hooks, wins every min, and stops every pointer chain, in both
    implementations of every op.

The CUDA kernels mask their ragged tails themselves, so nothing is padded.

**Block sizes.** Each connectivity kernel launches ``DEFAULT_BLOCK_M``
(256) threads a block, ``csrc/common.cuh``'s ``kThreads``: the tuner's
block ladder is that one point (``repro_torch.tune.space``). The ops take
the reference's ``block_m``; on the card they refuse any other explicit
value, and the plain versions ignore it, as the reference's ``ref`` policy
does. ``tuned_block_m`` is what the tuning cache resolves to.

``KERNELS`` also holds the ML-era ``embedding_bag`` wrapper and its
backward, dispatched in ``kernels/legacy``, and the threefry draws of
``repro_torch.random`` (``threefry_bits``, ``threefry_randint``, dispatched
here), so that ``launch_counts()`` covers every kernel.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from ..device import on_cuda
from .edge_relabel import kernel as _edge_relabel_kernel
from .edge_relabel.ref import edge_relabel_ref, edge_rewrite_ref
from .hook_compress import kernel as _hook_compress_kernel
from .hook_compress.ref import hook_compress_ref
from .legacy.embedding_bag import kernel as _embedding_bag_kernel
from .pointer_jump import kernel as _pointer_jump_kernel
from .pointer_jump.ref import pointer_jump_ref
from .scatter_min import kernel as _scatter_min_kernel
from .scatter_min.ref import scatter_min_ref
from .threefry import kernel as _threefry_kernel
from .threefry.ref import threefry_bits_ref, threefry_randint_ref

__all__ = ["scatter_min", "pointer_jump", "hook_compress", "edge_relabel",
           "edge_rewrite", "compact_mask", "embedding_bag", "threefry_bits",
           "threefry_randint", "launch_counts",
           "reset_launch_counts", "tuned_block_m", "clear_tuned_blocks",
           "KERNELS", "KERNEL_CONTRACT_VERSION", "DEFAULT_BLOCK_M"]

# The dispatch contract the tuning cache's winners were measured under
# (repro_torch.tune.cache drops entries of another version): the dump-slot
# and -1 semantics above, and a block size that is a kernel's threads a
# block. Bump it when either changes.
KERNEL_CONTRACT_VERSION = 1
# the one block size the connectivity kernels are built for (kThreads)
DEFAULT_BLOCK_M = 256

# the CUDA wrappers, each with its ``launches`` counter
KERNELS = {
    "hook_compress": _hook_compress_kernel.hook_compress,
    "pointer_jump": _pointer_jump_kernel.pointer_jump,
    "scatter_min": _scatter_min_kernel.scatter_min,
    "edge_relabel": _edge_relabel_kernel.edge_relabel,
    "edge_rewrite": _edge_relabel_kernel.edge_rewrite,
    "embedding_bag": _embedding_bag_kernel.embedding_bag,
    "embedding_bag_backward": _embedding_bag_kernel.embedding_bag_backward,
    "threefry_bits": _threefry_kernel.threefry_bits,
    "threefry_randint": _threefry_kernel.threefry_randint,
}


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


_TUNED_BLOCKS: dict = {}


def tuned_block_m(primitive: str, device="cuda") -> int:
    """The block size the tuning cache resolves for ``primitive`` on
    ``device`` (``repro_torch.tune.resolve_block_m``), else
    ``DEFAULT_BLOCK_M``; memoized per process and device,
    ``clear_tuned_blocks`` drops the memo."""
    key = (primitive, device)
    if key not in _TUNED_BLOCKS:
        from ..tune.tuner import resolve_block_m  # lazy: tune imports ops
        _TUNED_BLOCKS[key] = resolve_block_m(primitive, device=device)
    return _TUNED_BLOCKS[key]


def clear_tuned_blocks() -> None:
    """Forget the memoized block sizes: the next lookup reads the cache."""
    _TUNED_BLOCKS.clear()


def _check_block(primitive: str, block_m: Optional[int]) -> None:
    """A CUDA launch takes no block size but the one it is built for."""
    if block_m is not None and block_m != DEFAULT_BLOCK_M:
        raise ValueError(f"{primitive}: block_m={block_m!r}, but the CUDA "
                         f"kernels are built for {DEFAULT_BLOCK_M} threads "
                         f"a block only")


def scatter_min(P: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                block_m: Optional[int] = None) -> torch.Tensor:
    """``P[idx] = min(P[idx], vals)`` — the paper's writeMin (Appendix A).

    Negative, masked, and out-of-range targets are dumped (no-op scatter of
    the dtype's max sentinel), so ``P``'s dump row and any non-label buffer
    (e.g. a forest edge-id buffer) are safe targets."""
    n = P.shape[0] - 1
    big = torch.iinfo(P.dtype).max
    ok = (idx >= 0) & (idx <= n)
    if mask is not None:
        ok = ok & mask
    idx = torch.where(ok, idx, n).to(torch.int32)
    vals = torch.where(ok, vals.to(P.dtype), big)
    if on_cuda(P):
        _check_block("scatter_min", block_m)
        return _scatter_min_kernel.scatter_min(P, idx, vals)
    return scatter_min_ref(P, idx, vals)


def pointer_jump(labels: torch.Tensor, *, k: int = 1,
                 block_m: Optional[int] = None) -> torch.Tensor:
    """``k`` chained shortcut hops through the round-start snapshot.

    ``k=1`` is exactly one ``P ← P[P]`` round; chained hops compose, so
    ``k=3`` in one call equals two successive rounds (FindHalve). ``-1``
    labels and self-labeled slots are fixed points."""
    if on_cuda(labels):
        _check_block("pointer_jump", block_m)
        return _pointer_jump_kernel.pointer_jump(labels, k=k)
    return pointer_jump_ref(labels, k=k)


def hook_compress(P: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor, *, k: int = 1,
                  mask: Optional[torch.Tensor] = None,
                  block_m: Optional[int] = None) -> torch.Tensor:
    """One fused uf_sync round: root-masked min-hook + ``k`` shortcut hops.

    Equivalent to ``write_min(P, P[s], P[r], root-mask)`` followed by
    ``pointer_jump(·, k)`` on the hooked array. ``mask=False`` edges are
    rewritten onto the dump row first (a no-op hook under the dump-slot
    contract)."""
    if mask is not None:
        dump = P.shape[0] - 1
        senders = torch.where(mask, senders, dump).to(senders.dtype)
        receivers = torch.where(mask, receivers, dump).to(receivers.dtype)
    if on_cuda(P):
        _check_block("hook_compress", block_m)
        return _hook_compress_kernel.hook_compress(P, senders, receivers, k=k)
    return hook_compress_ref(P, senders, receivers, k=k)


def edge_relabel(labels: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor, *,
                 block_m: Optional[int] = None) -> torch.Tensor:
    """One relabel round: propose each endpoint's label to the other, merge
    with scatter-min (the Liu–Tarjan ParentConnect rule). Negative endpoints
    propose their value but are never targets."""
    if on_cuda(labels):
        _check_block("edge_relabel", block_m)
        return _edge_relabel_kernel.edge_relabel(labels, senders, receivers)
    return edge_relabel_ref(labels, senders, receivers)


def edge_rewrite(labels: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor, *, block_m: Optional[int] = None):
    """Rewrite edge endpoints to their parents (the Liu–Tarjan alter step):
    ``e ← P[e]`` with ``-1`` fixed points."""
    if on_cuda(labels):
        _check_block("edge_rewrite", block_m)
        return _edge_relabel_kernel.edge_rewrite(labels, senders, receivers)
    return edge_rewrite_ref(labels, senders, receivers)


def threefry_bits(out: torch.Tensor, k1: int, k2: int,
                  start: int) -> torch.Tensor:
    """Fill the int64 ``out`` (n,) with ``jax.random``'s threefry bits of
    elements ``start`` .. ``start + n - 1`` under the key words
    ``(k1, k2)`` (``repro_torch.random``'s draws)."""
    if on_cuda(out):
        return _threefry_kernel.threefry_bits(out, k1, k2, start)
    return threefry_bits_ref(out, k1, k2, start)


def threefry_randint(maxval: torch.Tensor, minval: int, higher_key: tuple,
                     lower_key: tuple) -> torch.Tensor:
    """``jax.random.randint``'s int32 draw in ``[minval, maxval)`` for each
    of the int32 ``maxval`` (n,), from ``split(key)``'s two key words."""
    if on_cuda(maxval):
        return _threefry_kernel.threefry_randint(maxval, minval, higher_key,
                                                 lower_key)
    return threefry_randint_ref(maxval, minval, higher_key, lower_key)


def compact_mask(mask: torch.Tensor, vals: torch.Tensor, cap: int) -> tuple:
    """Stream-compact the ``True`` positions of ``mask`` (and their
    ``vals``) into fixed ``(cap,)`` buffers: the frontier exchange of the
    sharded merge (core/distributed.py).

    Returns ``(idx, out)``: ``idx[j]`` is the j-th set position (int32, in
    mask order) and ``out[j]`` its value; unused slots hold ``idx = -1`` and
    the value dtype's max, so the pair feeds ``scatter_min`` as it is.
    Positions past ``cap`` are dropped: callers gate on the mesh-reduced
    frontier count first. A cumsum and two scatters with no host sync, in
    plain PyTorch on both devices, as the JAX package's jnp version is for
    every kernel policy (no kernel: the op is small beside the scatter_min
    it feeds)."""
    m = mask.shape[0]
    big = torch.iinfo(vals.dtype).max
    pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(mask & (pos < cap), pos, cap).long()  # overflow: slot cap
    src = torch.arange(m, dtype=torch.int32, device=mask.device)
    idx = torch.full((cap + 1,), -1, dtype=torch.int32, device=mask.device)
    idx[tgt] = src
    out = torch.full((cap + 1,), big, dtype=vals.dtype, device=vals.device)
    out[tgt] = torch.where(mask, vals, big)
    return idx[:cap], out[:cap]


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """Deprecated: the ML-era kernel lives in ``repro_torch.kernels.legacy``
    (its consumer is the DLRM model in ``repro_torch.legacy``). Import
    ``embedding_bag`` from there directly."""
    warnings.warn(
        "ops.embedding_bag is deprecated — the kernel moved to "
        "repro_torch.kernels.legacy (no connectivity consumer)",
        DeprecationWarning, stacklevel=2)
    from .legacy import embedding_bag as _embedding_bag
    return _embedding_bag(table, idx, mode=mode)
