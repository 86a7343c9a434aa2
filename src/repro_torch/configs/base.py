"""Architecture registry: each arch is a selectable config with its input
shapes (mirrors ``repro.configs.base``)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict

# the reference's arch ids, in its order; the port registers all of them
ARCH_IDS = [
    # LM-family (5)
    "h2o-danube-3-4b", "qwen3-4b", "stablelm-3b",
    "deepseek-moe-16b", "granite-moe-3b-a800m",
    # GNN (4)
    "pna", "egnn", "gin-tu", "nequip",
    # recsys (1)
    "dlrm-rm2",
    # the paper's own workload
    "connectit",
]

LM_SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1,
                      requires_subquadratic=True),
}

GNN_SHAPES: Dict[str, dict] = {
    "full_graph_sm": dict(kind="full", n=2708, m=10556, d_feat=1433,
                          n_classes=7),
    "minibatch_lg": dict(kind="minibatch", n=232965, m=114615892, d_feat=602,
                         n_classes=41, batch=1024, fanout=(15, 10)),
    "ogb_products": dict(kind="full", n=2449029, m=61859140, d_feat=100,
                         n_classes=47),
    "molecule": dict(kind="molecule", nodes=30, edges=64, batch=128,
                     d_feat=16, n_classes=2),
    # the reference's explicit-SPMD variant of ogb_products
    # (legacy/models/gnn_spmd.py, in both packages): the loss over the real
    # rows, node state split over the data axes on a mesh
    "ogb_products_spmd": dict(kind="full", n=2449029, m=61859140, d_feat=100,
                              n_classes=47, spmd=True),
}

RECSYS_SHAPES: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

# ConnectIt production-scale cells: the reference's, key for key.
CONNECTIT_SHAPES: Dict[str, dict] = {
    "static_1b_edges": dict(kind="static", n=1 << 26, m=1 << 30,
                            labels="replicated", rounds=8),
    "static_8b_edges_sharded": dict(kind="static", n=1 << 28, m=1 << 31,
                                    labels="sharded", rounds=8),
    "ingest_256m_batch": dict(kind="ingest", n=1 << 26, batch=1 << 28,
                              queries=1 << 20, rounds=4),
    "static_8b_sharded_fused": dict(kind="static", n=1 << 28, m=1 << 31,
                                    labels="sharded", rounds=8, jumps=8,
                                    variant="fused"),
}


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str            # lm | gnn | recsys | connectit
    model: Any
    shapes: Dict[str, dict]
    smoke: Dict[str, Any]  # reduced-config overrides for CPU tests

    def shape_names(self) -> list[str]:
        return list(self.shapes)

    def supports(self, shape_name: str) -> bool:
        """Whether the arch runs the shape: a long-context shape
        (``requires_subquadratic``) only with sliding-window attention."""
        spec = self.shapes[shape_name]
        if spec.get("requires_subquadratic"):
            return bool(getattr(self.model, "swa_window", None))
        return True


_REGISTRY: Dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    _REGISTRY[arch.name] = arch
    return arch


def get_arch(name: str) -> Arch:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> list[str]:
    """The registered archs in the reference's order (``ARCH_IDS``)."""
    if not _REGISTRY:
        load_all()
    return [a for a in ARCH_IDS if a in _REGISTRY]


def load_all() -> None:
    for mod in ["connectit_cfg"]:
        importlib.import_module(f"repro_torch.configs.{mod}")
    for mod in ["pna", "egnn", "gin_tu", "nequip_cfg", "dlrm_rm2",
                "h2o_danube_3_4b", "qwen3_4b", "stablelm_3b",
                "deepseek_moe_16b", "granite_moe_3b_a800m"]:
        importlib.import_module(f"repro_torch.configs.legacy.{mod}")
