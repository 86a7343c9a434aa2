"""Plain PyTorch version of the fused hook+compress kernel.

One synchronous ``uf_sync`` round (ConnectIt's union-find hook rule plus
per-round compression, paper §3.3 / Appendix A):

  1. gather round-start parents ``pu = P[s]``, ``pv = P[r]``;
  2. root-mask: hook only when ``pu`` is a round-start root and ``pv < pu``;
  3. scatter-min the winning proposals into the label array (writeMin);
  4. ``k`` chained shortcut hops through the *hooked* array snapshot.

``-1`` (the virtual minimum pinning L_max) is a fixed point of every phase.
"""

from __future__ import annotations

import torch

from ..index import take
from ..pointer_jump.ref import pointer_jump_ref

# edges proposed per pass of the hook: the proposals read only the
# round-start labels, so passes over slices of the edges min-combine into
# the same hooked array, and the int64 temporaries stay a slice's size
EDGE_CHUNK = 1 << 26


def hook_compress_ref(labels: torch.Tensor, senders: torch.Tensor,
                      receivers: torch.Tensor, *, k: int = 1) -> torch.Tensor:
    """labels (L,) int; senders/receivers (m,) int in [0, L).

    Padded edges must point at a self-labeled dump slot. An endpoint
    outside [0, L) is read as the JAX package's gather reads it
    (``index.take``)."""
    big = torch.iinfo(labels.dtype).max
    dump = labels.shape[0] - 1
    hooked = labels.clone()
    for lo in range(0, senders.shape[0], EDGE_CHUNK):
        pu = take(labels, senders[lo: lo + EDGE_CHUNK])
        pv = take(labels, receivers[lo: lo + EDGE_CHUNK])
        ppu = torch.where(pu < 0, pu, labels[pu.clamp_min(0).long()])
        ok = (pu >= 0) & (ppu == pu) & (pv < pu)
        tgt = torch.where(ok, pu, dump)
        val = torch.where(ok, pv, big)
        hooked.scatter_reduce_(0, tgt.long(), val, "amin", include_self=True)
    return pointer_jump_ref(hooked, k=k)
