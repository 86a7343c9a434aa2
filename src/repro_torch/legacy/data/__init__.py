"""Deterministic synthetic data streams (mirrors ``repro.legacy.data``).

Every batch is a function of ``(seed, step)`` alone: the LM and DLRM
streams' are the reference's, drawn on the target device from
``fold_in(PRNGKey(seed), step)`` with ``repro_torch.random``
(``jax.random``'s numbers: the tokens, ids, labels and GNN seed nodes are
the reference's bit for bit, DLRM's dense features within ``normal``'s
ulps), and the edge stream's is a slice of its host edge list.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ... import random as trandom
from ...device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """LM batches: markov-ish synthetic token sequences."""

    vocab: int
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int, *, device=DEFAULT_DEVICE) -> dict:
        """``{"tokens": (B, S) int32, "labels": (B, S) int32}``, the labels
        the tokens shifted by one: a third of the positions (where the drawn
        token is a multiple of 3) continue ``first + delta * position``."""
        key = trandom.fold_in(trandom.PRNGKey(self.seed, device=device),
                              step)
        k1, k2 = trandom.split(key)
        n = self.seq_len + 1
        base = trandom.randint(k1, (self.batch, n), 0, self.vocab)
        # inject local structure: next token ≈ prev + delta mod vocab
        delta = trandom.randint(k2, (self.batch, 1), 1, 17)
        steps = torch.arange(n, dtype=torch.int32, device=base.device)
        drift = (base[:, :1] + delta * steps) % self.vocab
        toks = torch.where(base % 3 == 0, drift, base).to(torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


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
class GraphNodeStream:
    """Seed-node batches for sampled GNN training."""

    n_nodes: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int, *, device=DEFAULT_DEVICE) -> dict:
        """``{"seeds": (batch,) int32 in [0, n_nodes), "key": the step's
        sampling key}``."""
        key = trandom.fold_in(trandom.PRNGKey(self.seed, device=device),
                              step)
        seeds = trandom.randint(key, (self.batch,), 0, self.n_nodes)
        return {"seeds": seeds, "key": trandom.fold_in(key, 1)}


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
