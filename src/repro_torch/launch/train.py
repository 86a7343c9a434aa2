"""Training driver: real steps on a reduced config (``--device cpu``) or the
full one on the card (mirrors ``repro.launch.train``).

Fault-tolerance loop: deterministic data (batch = f(seed, step)), a
checkpoint every N steps (atomic, k-retention, ``legacy.checkpoint``),
auto-resume from the latest one, and ``--simulate-failure K``, which kills
the process at step K: rerun the same command and the run goes on bit-exact
(the weights, the data and the gradient kernels are all deterministic).

The weights start from the reference's ``init_dlrm(PRNGKey(seed))`` and the
batches are the reference's ``RecsysStream`` (``repro_torch.random`` draws
``jax.random``'s numbers), so a run follows the reference's within float32
rounding. The ``recsys`` family (DLRM) is ported; ``lm`` and ``gnn`` are
ROADMAP Queue 1 item 16.

Usage:
  python -m repro_torch.launch.train --arch dlrm-rm2 --steps 50 \\
      --ckpt-dir /tmp/run1 [--full] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from .. import random as trandom
from ..configs import get_arch
from ..device import DEFAULT_DEVICE, resolve_device
from ..legacy import checkpoint as ckpt
from ..legacy import optim
from ..legacy.data import RecsysStream
from ..legacy.models import dlrm as dlrm_mod
from .steps import train_step


def smoke_model(arch):
    """Apply the arch's reduced-config overrides (CPU-runnable)."""
    return dataclasses.replace(arch.model, **arch.smoke)


def build_trainable(arch_name: str, *, smoke: bool = True, seed: int = 0,
                    device=DEFAULT_DEVICE):
    """Returns ``(model, opt_state, step_fn, data_fn)`` for a real run:
    ``step_fn(model, opt_state, batch) -> (model, opt_state, loss)`` updates
    both in place; ``data_fn(step)`` is the batch of ``step``."""
    arch = get_arch(arch_name)
    dev = resolve_device(device)
    key = trandom.PRNGKey(seed, device=dev)
    ocfg = optim.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    mcfg = smoke_model(arch) if smoke else arch.model

    if arch.family == "recsys":
        model = dlrm_mod.init_dlrm(mcfg, key=key)
        stream = RecsysStream(batch=64, n_dense=mcfg.n_dense,
                              n_sparse=mcfg.n_sparse,
                              vocab=min(mcfg.vocab_sizes),
                              multi_hot=mcfg.multi_hot, seed=seed)

        def step_fn(model, opt_state, batch):
            model, opt_state, info = train_step(
                model, opt_state, batch["dense"], batch["sparse"],
                batch["labels"], ocfg)
            return model, opt_state, info["loss"]

        def data_fn(step):
            return stream.batch_at(step, device=dev)

        return model, optim.init_adam(model.params()), step_fn, data_fn

    if arch.family in ("lm", "gnn"):
        raise NotImplementedError(
            f"{arch_name}: the {arch.family} family is not ported yet "
            f"(ROADMAP Queue 1 item 16)")
    raise ValueError(arch.family)


@torch.no_grad()
def _load_into(model, opt_state, tree) -> optim.AdamState:
    """Copy a restored ``(params, opt_state)`` into the model's parameters
    and the live optimizer state, in place."""
    params, restored = tree
    for dst, src in zip(optim.tree_leaves((model.params(), opt_state)),
                        optim.tree_leaves((params, restored))):
        dst.copy_(src)
    return opt_state


def train(arch_name: str, steps: int, ckpt_dir: str | None = None,
          ckpt_every: int = 20, simulate_failure: int = -1,
          smoke: bool = True, seed: int = 0, log_every: int = 10, *,
          device=DEFAULT_DEVICE):
    """Run ``steps`` steps (from the latest checkpoint under ``ckpt_dir``,
    if any) → ``(model, losses of this run's steps)``."""
    model, opt_state, step_fn, data_fn = build_trainable(
        arch_name, smoke=smoke, seed=seed, device=device)
    start = 0
    manager = None
    if ckpt_dir:
        manager = ckpt.CheckpointManager(ckpt_dir, every=ckpt_every)
        tree, start = manager.resume_or((model.params(), opt_state))
        if start:
            opt_state = _load_into(model, opt_state, tree)
            print(f"[train] resumed from step {start}")
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        batch = data_fn(step)
        model, opt_state, loss = step_fn(model, opt_state, batch)
        losses.append(float(loss))
        if step % log_every == 0:
            print(f"[train] step={step} loss={float(loss):.4f}")
        if manager:
            manager.maybe_save((model.params(), opt_state), step + 1)
        if simulate_failure == step:
            print(f"[train] SIMULATED FAILURE at step {step}", flush=True)
            os._exit(42)
    if manager:
        manager.maybe_save((model.params(), opt_state), steps, force=True)
    dt = time.time() - t0
    print(f"[train] {steps - start} steps in {dt:.1f}s "
          f"({(steps - start) / max(dt, 1e-9):.2f} it/s) "
          f"final loss {losses[-1] if losses else float('nan'):.4f}")
    return model, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--full", action="store_true",
                    help="the full (non-smoke) model config, for the card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    train(args.arch, args.steps, args.ckpt_dir, args.ckpt_every,
          args.simulate_failure, smoke=not args.full, seed=args.seed,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
