"""Deterministic synthetic data streams (mirrors ``repro.legacy.data``).

Every batch is a function of ``(seed, step)`` alone, drawn on the target
device from a ``torch.Generator`` seeded with both. The recipe is the
reference's; the draws are not ``jax.random``'s, so the parity tests hand
both packages the same numpy inputs instead.
"""

from __future__ import annotations

import dataclasses

import torch

from ...device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class RecsysStream:
    """DLRM batches: dense gaussians + zipfian sparse ids + planted CTR."""

    batch: int
    n_dense: int
    n_sparse: int
    vocab: int
    multi_hot: int = 1
    seed: int = 0

    def batch_at(self, step: int, *, device=DEFAULT_DEVICE) -> dict:
        """``{"dense": (B, n_dense) float32, "sparse": (B, n_sparse, L)
        int32 ids in [0, vocab), "labels": (B,) int32}``."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed((self.seed << 32) + step)
        dense = torch.randn(self.batch, self.n_dense, generator=g, device=dev)
        u = torch.rand(self.batch, self.n_sparse, self.multi_hot,
                       generator=g, device=dev) * (1 - 1e-6) + 1e-6
        zipf = (self.vocab ** u - 1.0) / (self.vocab - 1.0) * self.vocab
        sparse = zipf.to(torch.int32).clamp_(0, self.vocab - 1)
        logit = (dense.sum(-1) * 0.3
                 + (sparse[..., 0].sum(-1) % 7 - 3).float() * 0.2)
        labels = (torch.rand(self.batch, generator=g, device=dev)
                  < torch.sigmoid(logit)).to(torch.int32)
        return {"dense": dense, "sparse": sparse, "labels": labels}
