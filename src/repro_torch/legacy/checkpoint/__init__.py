"""Fault-tolerant checkpoints (mirrors ``repro.legacy.checkpoint``).

Atomic-rename ``.npz`` snapshots of a nested dict, tuple, list or
``NamedTuple`` of tensors (the reference's pytree) with ``keep``-retention
and resume discovery. The on-disk layout is the reference's: under a
directory, ``ckpt_<step:010d>.npz`` holds ``leaf_0 … leaf_{k-1}`` in the
reference's leaf order (dict keys sorted, sequences in order) and
``ckpt_<step:010d>.npz.json`` the step and leaf count. So a checkpoint the
JAX package wrote restores here, and the other way round. Leaves are
stored as whole (unsharded) host arrays; ``restore(..., device=)`` puts
each on a device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz")


def _flatten(tree) -> tuple[list, Callable]:
    """``(leaves, rebuild)``: the leaves in the reference's order, and a
    function that puts new leaves back into the same structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (ls, rb) in zip(keys, parts):
                out[k] = rb(leaves[i: i + len(ls)])
                i += len(ls)
            return out
        return [x for ls, _ in parts for x in ls], rebuild
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]

        def rebuild(leaves):
            out, i = [], 0
            for ls, rb in parts:
                out.append(rb(leaves[i: i + len(ls)]))
                i += len(ls)
            if hasattr(tree, "_fields"):  # a NamedTuple
                return type(tree)(*out)
            return type(tree)(out)
        return [x for ls, _ in parts for x in ls], rebuild
    if tree is None:
        return [], lambda leaves: None
    return [tree], lambda leaves: leaves[0]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree: Any, *, step: int, keep: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Write a checkpoint atomically to ``<path>/ckpt_<step>.npz`` (and its
    meta JSON) → the file's path."""
    os.makedirs(path, exist_ok=True)
    leaves, _ = _flatten(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    meta = {"step": int(step), "treedef": type(tree).__name__,
            "n_leaves": len(leaves)}
    if extra_meta:
        meta.update(extra_meta)
    final = os.path.join(path, f"ckpt_{step:010d}.npz")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, final)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(final + ".json", "w") as f:
        json.dump(meta, f)
    _retain(path, keep)
    return final


def _retain(path: str, keep: int) -> None:
    ckpts = sorted(f for f in os.listdir(path) if _CKPT_RE.fullmatch(f))
    for f in ckpts[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(path, f))
        meta = os.path.join(path, f + ".json")
        if os.path.exists(meta):
            os.unlink(meta)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := _CKPT_RE.fullmatch(f))]
    return max(steps) if steps else None


def restore(path: str, tree_like: Any, *, step: Optional[int] = None,
            device=None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like`` → ``(tree, step)``. Each
    leaf goes to ``device``, by default to the device of ``tree_like``'s
    leaf in its place (the CPU where that is not a tensor)."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    leaves, rebuild = _flatten(tree_like)
    with np.load(os.path.join(path, f"ckpt_{step:010d}.npz")) as data:
        if len(leaves) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, the "
                             f"structure needs {len(leaves)}")
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves))]
    new = []
    for x, like in zip(arrays, leaves):
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        new.append(torch.from_numpy(x).to(dev))
    return rebuild(new), step


@dataclasses.dataclass
class CheckpointManager:
    """Every-N-steps save and resume."""

    path: str
    every: int = 100
    keep: int = 3

    def maybe_save(self, tree, step: int, force: bool = False):
        if force or (step > 0 and step % self.every == 0):
            return save(self.path, tree, step=step, keep=self.keep)
        return None

    def resume_or(self, tree_like, device=None):
        """The latest checkpoint restored into ``tree_like``'s structure →
        ``(tree, step)``, or ``(tree_like, 0)`` where there is none."""
        step = latest_step(self.path)
        if step is None:
            return tree_like, 0
        return restore(self.path, tree_like, step=step, device=device)
