"""Architecture registry: each arch is a selectable config with its input
shapes (mirrors ``repro.configs.base``)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict

RECSYS_SHAPES: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str            # recsys (lm | gnn | connectit: not ported yet)
    model: Any
    shapes: Dict[str, dict]
    smoke: Dict[str, Any]  # reduced-config overrides for CPU tests


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
    if not _REGISTRY:
        load_all()
    return list(_REGISTRY)


def load_all() -> None:
    for mod in ["dlrm_rm2"]:
        importlib.import_module(f"repro_torch.configs.legacy.{mod}")
