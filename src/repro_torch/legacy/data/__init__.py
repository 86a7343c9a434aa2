"""Deterministic synthetic data streams (mirrors ``repro.legacy.data``).

Every batch is a function of ``(seed, step)`` alone: the DLRM stream's is
the reference's, drawn on the target device from ``fold_in(PRNGKey(seed),
step)`` with ``repro_torch.random`` (``jax.random``'s numbers: the ids and
labels are the reference's, the dense features within ``normal``'s ulps),
and the edge stream's is a slice of its host edge list.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ... import random as trandom
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
        key = trandom.fold_in(trandom.PRNGKey(self.seed, device=device),
                              step)
        kd, ks, kl = trandom.split(key, 3)
        dense = trandom.normal(kd, (self.batch, self.n_dense))
        u = trandom.uniform(ks, (self.batch, self.n_sparse, self.multi_hot),
                            minval=1e-6)
        # vocab ** u in float64, rounded once: the reference's float32 pow
        # (glibc's powf on the CPU) agrees but for ~0.06% of draws, where
        # the two differ by an ulp; float32 tensors as the divisor, so
        # that CUDA divides as the reference does
        f32 = dict(dtype=torch.float32, device=u.device)
        pw = torch.pow(float(self.vocab), u.double()).float()
        zipf = (pw - 1.0) / torch.tensor(self.vocab - 1.0, **f32) \
            * torch.tensor(float(self.vocab), **f32)
        sparse = zipf.to(torch.int32).clamp_(0, self.vocab - 1)
        logit = (dense.sum(-1) * 0.3
                 + (sparse[..., 0].sum(-1) % 7 - 3).float() * 0.2)
        labels = (trandom.uniform(kl, (self.batch,))
                  < torch.sigmoid(logit)).to(torch.int32)
        return {"dense": dense, "sparse": sparse, "labels": labels}


@dataclasses.dataclass(frozen=True)
class EdgeStream:
    """Streaming-connectivity insert batches drawn from a host edge list."""

    senders: np.ndarray
    receivers: np.ndarray
    batch: int
    n: int
    seed: int = 0
    device: Any = DEFAULT_DEVICE

    def num_batches(self) -> int:
        return -(-len(self.senders) // self.batch)

    def batch_at(self, step: int) -> dict:
        """``{"u": (batch,), "v": (batch,)}`` int32 on the stream's device:
        edges ``[step * batch, (step + 1) * batch)``, the tail padded with
        the dump id ``n`` on the host."""
        lo = step * self.batch
        hi = min(lo + self.batch, len(self.senders))
        bu = np.full((self.batch,), self.n, np.int32)
        bv = np.full((self.batch,), self.n, np.int32)
        bu[: hi - lo] = self.senders[lo:hi]
        bv[: hi - lo] = self.receivers[lo:hi]
        dev = resolve_device(self.device)
        return {"u": torch.from_numpy(bu).to(dev),
                "v": torch.from_numpy(bv).to(dev)}
