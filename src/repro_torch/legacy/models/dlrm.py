"""DLRM (arXiv:1906.00091), RM2 configuration (mirrors
``repro.legacy.models.dlrm``).

13 dense features → bottom MLP; 26 sparse multi-hot fields → one embedding
bag per table, through the dispatching ``embedding_bags`` (the hand-written
CUDA kernel on the card, its plain version on the CPU); dot-product feature
interaction (strict lower triangle); top MLP → CTR logit.

``retrieval_score`` is the retrieval_cand cell: one user vector against
10⁶ candidate embeddings as one GEMV and a top-k.

Trainable: the bags are one ``torch.autograd.Function`` whose backward is
one call of the hand-written CUDA backward for all 26 tables on the card. ``params()`` is
the reference's parameter pytree (``{"tables": [...], "bot": {...}, "top":
{...}}``) of the module's own tensors, which ``legacy.optim`` updates in
place and ``legacy.checkpoint`` saves in the reference's leaf order.
Serving runs under ``inference_mode`` (``launch/steps.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ... import random as trandom
from ...kernels.legacy import embedding_bags
from .layers import MLP, mlp_init, normal

ROW_PAD = 512  # tables are padded to a multiple of this many rows


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_sizes: tuple = (1_000_000,) * 26
    multi_hot: int = 1            # bag length per field
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def table_rows(vocab: int) -> int:
    """Rows of a table: ``vocab`` ids, then zero rows up to a multiple of
    ``ROW_PAD`` (at least one: the last row is the bag's dump row)."""
    return -(-(vocab + 1) // ROW_PAD) * ROW_PAD


class DLRM(nn.Module):
    """The model; ``forward`` gives ``(B,)`` logits."""

    def __init__(self, cfg: DLRMConfig, tables: Sequence[torch.Tensor],
                 bot: MLP, top: MLP):
        super().__init__()
        if len(tables) != cfg.n_sparse:
            raise ValueError(f"{cfg.name}: {len(tables)} tables for "
                             f"{cfg.n_sparse} sparse fields")
        for t, v in zip(tables, cfg.vocab_sizes):
            if tuple(t.shape) != (table_rows(v), cfg.embed_dim):
                raise ValueError(f"{cfg.name}: a table of shape "
                                 f"{tuple(t.shape)} for vocab {v}, want "
                                 f"{(table_rows(v), cfg.embed_dim)}")
        self.cfg = cfg
        self.tables = nn.ParameterList(tables)
        self.bot = bot
        self.top = top
        f = cfg.n_sparse + 1
        # jnp.tril_indices(f, k=-1) order, which the top MLP's weights follow
        self.register_buffer("tril", torch.tril_indices(
            f, f, offset=-1, device=tables[0].device), persistent=False)

    def params(self) -> dict:
        """The reference's pytree of this module's parameters (the tensors
        themselves, not copies)."""
        return {"tables": list(self.tables), "bot": self.bot.params(),
                "top": self.top.params()}

    def bags(self, sparse_idx: torch.Tensor) -> list:
        """The ``n_sparse`` sum-bags ``(B, D)`` of ``sparse_idx`` (B, n_sparse,
        L): one ``embedding_bags`` call for all the tables."""
        per_field = sparse_idx.to(torch.int32).transpose(0, 1).contiguous()
        return embedding_bags(list(self.tables), per_field)

    def forward(self, dense: torch.Tensor,
                sparse_idx: torch.Tensor) -> torch.Tensor:
        """dense: (B, n_dense) float; sparse_idx: (B, n_sparse, L) int →
        (B,) logits."""
        x = self.bot(dense)                                   # (B, D)
        z = torch.stack([x, *self.bags(sparse_idx)], dim=1)   # (B, 27, D)
        inter = torch.bmm(z, z.transpose(1, 2))               # (B, 27, 27)
        flat = inter[:, self.tril[0], self.tril[1]]           # (B, 351)
        return self.top(torch.cat([x, flat], dim=-1))[..., 0]

    def loss(self, dense: torch.Tensor, sparse_idx: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Mean binary cross-entropy of the logits."""
        logit = self.forward(dense, sparse_idx).float()
        y = labels.float()
        return torch.mean(torch.clamp(logit, min=0) - logit * y
                          + torch.log1p(torch.exp(-logit.abs())))

    def retrieval_score(self, dense: torch.Tensor, sparse_idx: torch.Tensor,
                        cand: torch.Tensor, top_k: int = 100):
        """Score one query (dense (1, n_dense), sparse (1, n_sparse, L))
        against ``cand`` (N_cand, D): ``(values, indices)`` of the top
        ``top_k`` float32 scores, largest first."""
        q = self.bot(dense)                                   # (1, D)
        q = q + sum(self.bags(sparse_idx))                    # fused user vec
        scores = (cand @ q[0]).float()                        # (N_cand,)
        return torch.topk(scores, top_k)


def init_dlrm(cfg: DLRMConfig, *, key=None, generator=None, device=None,
              dtype=torch.float32) -> DLRM:
    """Random weights: tables normal / sqrt(D) with the rows from ``V`` on
    zero, MLPs as ``mlp_init``. From a threefry ``key`` (on ``device``, the
    key's own when None) they are the reference's ``init_dlrm(key, cfg)``:
    table ``i`` draws from ``split(key, n_sparse + 2)[i]``, the bottom MLP
    from the one before last, the top MLP from the last. From a
    ``generator`` (which must live on ``device``) they are torch's numbers.
    Each table is drawn where it lives, so the 6.66 GB of RM2's tables
    never pass through the host."""
    if (key is None) == (generator is None):
        raise ValueError("init_dlrm: pass one of key= and generator=")
    if key is not None:
        key = key.to(device) if device is not None else key
        device = key.device
        ks = trandom.split(key, cfg.n_sparse + 2)
        draw = [dict(key=ks[i]) for i in range(cfg.n_sparse)]
        bot_kw, top_kw = dict(key=ks[-2]), dict(key=ks[-1])
    else:
        draw = [dict(generator=generator)] * cfg.n_sparse
        bot_kw = top_kw = dict(generator=generator, device=device)
    root_d = torch.tensor(math.sqrt(cfg.embed_dim), device=device)
    tables = []
    for v, kw in zip(cfg.vocab_sizes, draw):
        t = normal((table_rows(v), cfg.embed_dim), device=device, **kw)
        t.div_(root_d)  # a float32 divide, as the reference's
        t[v:] = 0.0
        tables.append(t.to(dtype))
    bot = mlp_init([cfg.n_dense, *cfg.bot_mlp], dtype=dtype, final_relu=True,
                   **bot_kw)
    top = mlp_init([cfg.n_interactions + cfg.embed_dim, *cfg.top_mlp],
                   dtype=dtype, **top_kw)
    return DLRM(cfg, tables, bot, top)


def dlrm_from_jax(params: Mapping, cfg: DLRMConfig, *, device) -> DLRM:
    """The reference's ``init_dlrm`` pytree (``{"tables": [...], "bot":
    {"w0", "b0", ...}, "top": {...}}``, leaves as arrays) as the port's
    module. Weights keep their ``(d_in, d_out)`` layout."""
    tables = [torch.tensor(np.asarray(t), device=device)
              for t in params["tables"]]
    return DLRM(cfg, tables,
                MLP.from_params(params["bot"], final_relu=True, device=device),
                MLP.from_params(params["top"], final_relu=False,
                                device=device))
