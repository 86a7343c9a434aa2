"""Cell builders: (architecture × input shape × mesh) → a runnable step
(mirrors ``repro.launch.steps``: the ``recsys`` and ``connectit`` parts).

A cell is a step function, the global shapes of its inputs as ``meta``
tensors (allocated nowhere, like the reference's ``ShapeDtypeStruct``s),
how each input is split over the mesh (``in_shardings``) and its ``meta``
counts. A sharding is a tuple of mesh axis names: ``()`` for an input
whole on every rank, ``("model",)`` for a label window, the placement's
edge axes for edge-aligned inputs. Every rank calls ``fn`` on its own block
of each input (``local_block``; ``local_shape`` plans it without data), as
a ``shard_map`` body takes its blocks.

  * ``connectit``: the paper's production cells. The shape dict's
    ``labels``/``variant`` keys choose the placement, the finish comes from
    the arch's config (``ConnectItConfig.finish``); the step is the
    placement's finish program (``kind="static"``) or its stream process
    (``kind="ingest"``) from ``core/execution.py::make_backend``. Labels are
    ``(n + 1,)`` (dump row ``n``), padded with self-rooted ids to divide the
    label axis under the sharded placement. Built on a real mesh the cell
    runs; built on a ``launch.mesh.ShapeMesh`` with ``device="meta"`` it
    only plans (``launch/dryrun.py``).
  * ``recsys``: DLRM training, serving and retrieval on one device;
    ``fn(model, *inputs)``, and for training ``fn(model, opt_state,
    *inputs)``, which updates the model and the optimizer state in place
    (the reference donates both). The LM and GNN families are queued
    (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import dataclasses
from math import prod
from typing import Callable

import torch

from ..configs.base import Arch
from ..core import collectives as coll
from ..core.execution import ExecutionSpec, make_backend
from ..core.finish import make_finish
from ..graphs.containers import round_up
from ..legacy import optim
from ..legacy.models.dlrm import DLRM, DLRMConfig
from .mesh import all_axes, data_axes, make_smoke_mesh


OPT = optim.OptimizerConfig()


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable        # fn(*blocks); recsys: fn(model, [opt_state,] *inputs)
    args: tuple         # the inputs' global shapes, as meta tensors
    in_shardings: tuple = ()  # per input: the mesh axes it is split over
    donate: tuple = ()  # the arguments of fn the reference donates: the
    # connectivity programs write out of place, the train step in place
    meta: dict = dataclasses.field(default_factory=dict)


def local_shape(arg: torch.Tensor, sharding: tuple, mesh) -> tuple:
    """A rank's block shape of an input split over ``sharding``'s axes of
    ``mesh`` (a real or a shape-only mesh)."""
    k = coll.mesh_size(mesh, sharding)
    if arg.shape[0] % k:
        raise ValueError(f"an input of {arg.shape[0]} rows does not split "
                         f"over {sharding} ({k} ranks)")
    return (arg.shape[0] // k,) + tuple(arg.shape[1:])


def local_bytes(cell: Cell, mesh) -> int:
    """The bytes of one rank's blocks of every input."""
    return sum(prod(local_shape(a, sh, mesh)) * a.element_size()
               for a, sh in zip(cell.args, cell.in_shardings))


def local_block(x: torch.Tensor, sharding: tuple, mesh) -> torch.Tensor:
    """This rank's block of a global input (a view)."""
    per = local_shape(x, sharding, mesh)[0]
    i = coll.shard_index(mesh, sharding)
    return x[i * per: (i + 1) * per]


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


def train_step(model: DLRM, opt_state: optim.AdamState, dense: torch.Tensor,
               sparse: torch.Tensor, labels: torch.Tensor,
               ocfg: optim.OptimizerConfig = OPT):
    """One step of the reference's DLRM ``train_step``: the loss, its
    gradient with respect to every parameter, and ``optim.update``, in place
    on ``model``'s parameters and ``opt_state``'s moments → ``(model,
    opt_state, {"loss", "lr", "grad_norm"})``."""
    params = model.params()
    with torch.enable_grad():
        loss = model.loss(dense, sparse, labels)
        grads = torch.autograd.grad(loss, optim.tree_leaves(params))
    _, opt_state, info = optim.update(
        ocfg, params, optim.tree_unflatten(params, grads), opt_state)
    return model, opt_state, {"loss": loss.detach(), **info}


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
                    ((), ()), meta=dict(model_flops=_dlrm_model_flops(cfg, B), batch=B))
    if kind == "retrieval":
        n_cand = spec["n_candidates"]
        cand = _meta((n_cand, cfg.embed_dim), torch.float32)
        return Cell(arch.name, shape_name, retrieve, (dense, sparse, cand),
                    ((), (), ()), meta=dict(model_flops=2 * n_cand * cfg.embed_dim,
                              batch=1))
    if kind == "train":
        labels = _meta((B,), torch.int32)
        return Cell(arch.name, shape_name, train_step, (dense, sparse, labels),
                    ((), (), ()), donate=(0, 1),
                    meta=dict(model_flops=_dlrm_model_flops(cfg, B), batch=B))
    raise ValueError(f"{arch.name}: unknown shape kind {kind!r}")


# ---------------------------------------------------------------------------
# ConnectIt production cells (the paper's own workload on a mesh).
# ---------------------------------------------------------------------------

def _connectit_exec_spec(spec: dict, mesh) -> ExecutionSpec:
    rounds = spec.get("rounds", 8)
    if spec.get("labels", "replicated") == "replicated" or \
            spec["kind"] == "ingest":
        return ExecutionSpec("replicated", axes=all_axes(mesh), rounds=rounds)
    return ExecutionSpec(
        "sharded", axes=data_axes(mesh), label_axis="model", rounds=rounds,
        fused=(spec.get("variant") == "fused"
               or spec.get("use_reduce_scatter", False)))


def _connectit_finish(arch: Arch):
    return make_finish(getattr(arch.model, "finish", "uf_sync"))


def _connectit_cell(arch: Arch, shape_name: str, mesh, device) -> Cell:
    spec = arch.shapes[shape_name]
    n, rounds = spec["n"], spec.get("rounds", 8)
    exec_spec = _connectit_exec_spec(spec, mesh)
    backend = make_backend(exec_spec, mesh, device=device)
    finish_fn = _connectit_finish(arch)
    kind = spec["kind"]

    if exec_spec.placement == "sharded":
        n1 = round_up(n + 1, coll.axis_size(mesh, "model"))
        lshard = ("model",)
    else:
        n1 = n + 1
        lshard = ()
    labels = _meta((n1,), torch.int32)
    eshard = tuple(exec_spec.axes)

    if kind == "static":
        m = round_up(spec["m"], backend.edge_shards)
        edges = _meta((m,), torch.int32)
        return Cell(arch.name, shape_name, backend.finish_program(finish_fn),
                    (labels, edges, edges), (lshard, eshard, eshard),
                    donate=(0,),
                    meta=dict(edges=m, model_flops=0, loop_trips=rounds,
                              bytes_touched=rounds * (m * 8 + n * 8)))

    if kind == "ingest":
        bsz = round_up(spec["batch"], backend.edge_shards)
        q = round_up(spec["queries"], backend.edge_shards)
        fn = backend.stream_programs(finish_fn).process
        args = (labels, _meta((bsz,), torch.int32),
                _meta((bsz,), torch.int32), _meta((q,), torch.int32),
                _meta((q,), torch.int32))
        return Cell(arch.name, shape_name, fn, args, (lshard,) + (eshard,) * 4,
                    donate=(0,),
                    meta=dict(edges=bsz, model_flops=0, loop_trips=rounds,
                              bytes_touched=rounds * (bsz * 8 + n * 8)))
    raise ValueError(f"{arch.name}: unknown shape kind {kind!r}")


def build_cell(arch: Arch, shape_name: str, mesh=None, *,
               device="cuda") -> Cell:
    """The cell of ``arch`` at ``shape_name``. A ``connectit`` cell runs on
    ``mesh`` (default: the ``(data, model)`` mesh over every rank of the
    world, ``launch.mesh.make_smoke_mesh``) and ``device``; on a
    ``ShapeMesh``, pass ``device="meta"``."""
    if shape_name not in arch.shapes:
        raise KeyError(f"{arch.name} has no shape {shape_name!r}; have "
                       f"{sorted(arch.shapes)}")
    if arch.family == "recsys":
        return _dlrm_cell(arch, shape_name, arch.model)
    if arch.family == "connectit":
        device = torch.device(device)
        if mesh is None:
            mesh = make_smoke_mesh(device.type)
        return _connectit_cell(arch, shape_name, mesh, device)
    raise NotImplementedError(
        f"{arch.name}: the {arch.family} family is not ported yet (ROADMAP "
        f"Queue 1 item 16)")
