"""Cell builders: (architecture × input shape) → a runnable step on one
device (mirrors the ``recsys`` part of ``repro.launch.steps``).

A cell is a step function, the shapes of its inputs as ``meta`` tensors
(allocated nowhere, like the reference's ``ShapeDtypeStruct``s) and its
``meta`` counts. The port has no mesh yet: the reference's shard function is
the identity here, and a cell runs on the device its model and inputs are
on. Only the ``recsys`` family is ported; DLRM training is queued with the
bag's backward (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import Arch
from ..legacy.models.dlrm import DLRM, DLRMConfig


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable   # fn(model, *inputs)
    args: tuple    # the inputs after the model, as meta tensors
    meta: dict = dataclasses.field(default_factory=dict)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dlrm_model_flops(cfg: DLRMConfig, batch: int) -> int:
    """Matmul FLOPs of the two MLPs (the reference's count; the
    embedding-bag bytes, 26 gathers of B × D rows, dominate all the same)."""
    bot = sum(a * b for a, b in zip((cfg.n_dense,) + cfg.bot_mlp[:-1],
                                    cfg.bot_mlp))
    top = sum(a * b for a, b in zip(
        (cfg.n_interactions + cfg.embed_dim,) + cfg.top_mlp[:-1],
        cfg.top_mlp))
    return 2 * batch * (bot + top)


def serve_step(model: DLRM, dense: torch.Tensor,
               sparse: torch.Tensor) -> torch.Tensor:
    """Click probabilities ``sigmoid(forward)``, (B,)."""
    with torch.inference_mode():
        return torch.sigmoid(model(dense, sparse))


def retrieve(model: DLRM, dense: torch.Tensor, sparse: torch.Tensor,
             cand: torch.Tensor, top_k: int = 100):
    """``(values, indices)`` of the top ``top_k`` candidates for one query."""
    with torch.inference_mode():
        return model.retrieval_score(dense, sparse, cand, top_k=top_k)


def _dlrm_cell(arch: Arch, shape_name: str, cfg: DLRMConfig) -> Cell:
    spec = arch.shapes[shape_name]
    kind = spec["kind"]
    B = spec["batch"]
    dense = _meta((B, cfg.n_dense), torch.float32)
    sparse = _meta((B, cfg.n_sparse, cfg.multi_hot), torch.int32)
    if kind == "serve":
        return Cell(arch.name, shape_name, serve_step, (dense, sparse),
                    meta=dict(model_flops=_dlrm_model_flops(cfg, B), batch=B))
    if kind == "retrieval":
        n_cand = spec["n_candidates"]
        cand = _meta((n_cand, cfg.embed_dim), torch.float32)
        return Cell(arch.name, shape_name, retrieve, (dense, sparse, cand),
                    meta=dict(model_flops=2 * n_cand * cfg.embed_dim,
                              batch=1))
    if kind == "train":
        raise NotImplementedError(
            f"{arch.name} {shape_name}: DLRM training is not ported yet; it "
            f"needs a backward for embedding_bag (ROADMAP Queue 1 item 16)")
    raise ValueError(f"{arch.name}: unknown shape kind {kind!r}")


def build_cell(arch: Arch, shape_name: str) -> Cell:
    """The cell of ``arch`` at ``shape_name``."""
    if shape_name not in arch.shapes:
        raise KeyError(f"{arch.name} has no shape {shape_name!r}; have "
                       f"{sorted(arch.shapes)}")
    if arch.family == "recsys":
        return _dlrm_cell(arch, shape_name, arch.model)
    raise NotImplementedError(
        f"{arch.name}: the {arch.family} family is not ported yet (ROADMAP "
        f"Queue 1 item 16)")
