"""Per-family parameter and activation sharding rules (mirrors
``repro.launch.shardings``).

A *spec* is a per-dimension tuple, as a ``PartitionSpec`` is: each entry is
``None`` (the dimension is whole), a mesh axis name, or a tuple of names
(the dimension is split over those axes together, the first named varying
slowest). A spec shorter than its array leaves the trailing dimensions
whole, so ``()`` is an array whole on every rank. Specs are read from
``mesh.shape`` and ``mesh.mesh_dim_names`` only, so they are planned on a
``launch.mesh.ShapeMesh`` as on a ``DeviceMesh``.

Parameters take their spec from path-pattern rules (Megatron TP for the
dense LM, EP for the MoE experts, row-sharded tables for DLRM), then
*fitted* (``fit``): the rule is right-aligned on the leaf (stacked layer
leaves carry a leading ``L`` axis), an axis whose extent does not divide
its dimension is dropped and re-homed to another dimension it divides
(granite's vocabulary of 49,155 on 16 model ranks: ``embed`` goes to
``(None, "model")``), and a train cell adds FSDP over the data axes on the
largest dimension left free (leaves over 2^16 elements only, and not the
leaves ``fsdp_exclude`` names).

``make_shard_fn`` is the mesh-side counterpart of ``layers.no_shard``: the
object the LM's functions take as ``shard``. By itself it moves nothing:
it answers where the reference's activation constraints hold
(``layout``), holds the parameters' specs, and names the collectives the
mesh path makes (``legacy/models/spmd.py``).
"""

from __future__ import annotations

import re
from math import prod
from typing import Any, Optional

import torch

from ..legacy.models.spmd import (
    MeshShard,
    extent,
    local_block,
    local_shape,
    spec_axes,
    tree_paths,
    tree_rebuild,
)
from .mesh import data_axes

__all__ = ["LM_RULES", "DLRM_RULES", "extent", "fit", "param_specs",
           "batch_spec", "spec_axes", "local_shape", "local_block",
           "make_shard_fn", "tree_paths"]


def _entry(axes: tuple):
    """A spec entry for ``axes``: a name alone, as ``PartitionSpec`` keeps
    it."""
    return axes[0] if len(axes) == 1 else tuple(axes)


LM_RULES = [
    (r"embed$", ("model", None)),
    (r"lm_head$", (None, "model")),
    (r"(wq|wk|wv)$", (None, "model")),
    (r"wo$", ("model", None)),
    (r"ffn/(w_gate|w_up)$", (None, "model")),
    (r"ffn/w_down$", ("model", None)),
    (r"moe/router$", (None, None)),
    (r"moe/(w_gate|w_up|w_down)$", ("model", None, None)),   # EP
    (r"moe/shared/(w_gate|w_up)$", (None, "model")),
    (r"moe/shared/w_down$", ("model", None)),
    (r"(ln_attn|ln_ffn|final_norm|q_norm|k_norm|eps)$", ()),
]

DLRM_RULES = [
    (r"tables/\d+$", ("model", None)),   # vocab-row sharding
]

# leaves of at most this many elements stay out of FSDP
FSDP_MIN = 1 << 16


def fit(mesh, shape: tuple, rule: tuple, *, fsdp: bool) -> tuple:
    """The reference's ``_fit``: right-align ``rule`` on ``shape``, drop the
    assignments that do not divide, re-home each dropped axis to the last
    free dimension it divides, then (``fsdp``) put the data axes on the
    largest free dimension they divide."""
    dims = list(shape)
    nd = len(dims)
    rule = list(rule)
    assign = [None] * nd
    for i, a in enumerate(rule[-nd:] if len(rule) > nd else rule):
        assign[nd - min(len(rule), nd) + i] = a
    dropped = []
    for i in range(nd):
        if assign[i] is not None and dims[i] % extent(mesh, assign[i]):
            dropped.append(assign[i])
            assign[i] = None
    for a in dropped:
        for i in reversed(range(nd)):
            k = extent(mesh, a)
            if assign[i] is None and dims[i] % k == 0 and dims[i] >= k:
                assign[i] = a
                break
    if fsdp:
        dax = data_axes(mesh)
        if dax:
            k = extent(mesh, dax)
            cands = [i for i in range(nd) if assign[i] is None
                     and dims[i] % k == 0 and dims[i] >= k]
            if cands:
                assign[max(cands, key=lambda i: dims[i])] = _entry(dax)
    return tuple(assign)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else tuple(leaf)


def param_specs(shapes: Any, family: str, mesh, *, fsdp: bool = False,
                fsdp_exclude: Optional[str] = None) -> Any:
    """The spec of every leaf of ``shapes`` (a pytree of shape tuples or
    tensors), in its structure: the reference's ``param_specs``. The first
    rule whose pattern the leaf's path matches applies (none: whole),
    then ``fit``; a scalar is whole."""
    rules = {"lm": LM_RULES, "recsys": DLRM_RULES}.get(family, [])
    out = []
    for path, leaf in tree_paths(shapes):
        shape = _shape(leaf)
        rule = ()
        for pat, s in rules:
            if re.search(pat, path):
                rule = s
                break
        if not shape:
            out.append(())
            continue
        use_fsdp = fsdp and prod(shape) > FSDP_MIN
        if fsdp_exclude and re.search(fsdp_exclude, path):
            use_fsdp = False
        out.append(fit(mesh, shape, rule, fsdp=use_fsdp))
    return tree_rebuild(shapes, out)


def batch_spec(shape: tuple, mesh) -> tuple:
    """The reference's ``batch_sharding``: the leading dimension over the
    data axes where they divide it, else whole."""
    dax = data_axes(mesh)
    if not shape or not dax or shape[0] % extent(mesh, dax):
        return ()
    return (_entry(dax),) + (None,) * (len(shape) - 1)


def make_shard_fn(mesh, specs: Any = None, *, batch: Optional[int] = None):
    """The ``shard`` object of the LM's mesh path on ``mesh`` (a
    ``DeviceMesh``): ``specs`` is the model's parameter spec tree, and
    ``batch`` the global batch of the cell, which decides whether the
    batch is split over the data axes (the reference's ``batch_sharding``)
    or whole on every rank."""
    split = batch is not None and bool(batch_spec((batch,), mesh))
    return MeshShard(mesh, specs, batch_split=split)
