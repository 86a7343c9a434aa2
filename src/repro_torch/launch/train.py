"""Training driver: real steps on a reduced config (``--device cpu``) or the
full one on the card (mirrors ``repro.launch.train``).

Fault-tolerance loop: deterministic data (batch = f(seed, step)), a
checkpoint every N steps (atomic, k-retention, ``legacy.checkpoint``),
auto-resume from the latest one, and ``--simulate-failure K``, which kills
the process at step K: rerun the same command and the run goes on bit-exact
(the weights, the data and the gradients are all deterministic: the
embedding gradients and the MoE dispatch's backward add in a fixed
order).

The weights start from the reference's ``init_dlrm(PRNGKey(seed))``,
``init_params``, ``init_gnn`` or ``init_nequip`` and the batches are the
reference's ``RecsysStream`` or ``TokenStream``, or its GNN inputs on
``rmat(512, 2048, seed)`` (``repro_torch.random`` draws ``jax.random``'s
numbers), so a run follows the reference's within float32 rounding. Every
family is ported: ``recsys`` (DLRM), ``lm`` and ``gnn`` (GIN, PNA, EGNN,
NequIP; their gradients add in a fixed order through the ``segment_sum``
kernel).

Usage:
  python -m repro_torch.launch.train --arch dlrm-rm2 --steps 50 \\
      --ckpt-dir /tmp/run1 [--full] [--device cpu]
  python -m repro_torch.launch.train --arch qwen3-4b --steps 20 --device cpu
  python -m repro_torch.launch.train --arch gin-tu --steps 50 --device cpu
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
from ..graphs import generators as gen
from ..legacy.data import RecsysStream, TokenStream
from ..legacy.models import dlrm as dlrm_mod
from ..legacy.models import gnn as gnn_mod
from ..legacy.models import nequip as nequip_mod
from ..legacy.models import transformer as tfm
from .steps import gnn_train_step, lm_train_step, train_step


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

    if arch.family == "lm":
        model = tfm.init_transformer(mcfg, key=key)
        stream = TokenStream(vocab=mcfg.vocab, batch=8, seq_len=64,
                             seed=seed)

        def step_fn(model, opt_state, batch):
            model, opt_state, info = lm_train_step(
                model, opt_state, batch["tokens"], batch["labels"], mcfg,
                ocfg)
            return model, opt_state, info["loss"]

        def data_fn(step):
            return stream.batch_at(step, device=dev)

        return model, optim.init_adam(model.params()), step_fn, data_fn

    if arch.family == "gnn":
        g = gen.rmat(512, 2048, seed=seed, device=dev)
        n1 = g.n + 1
        fkey = trandom.fold_in(key, 1)
        ckey = trandom.fold_in(key, 2)
        if arch.name == "nequip":
            species = trandom.randint(fkey, (n1,), 0, mcfg.n_species)
            coords = trandom.normal(ckey, (n1, 3))
            model = nequip_mod.init_nequip(mcfg, key=key)

            def data_fn(step):
                tkey = trandom.fold_in(trandom.PRNGKey(seed + 7, device=dev),
                                       step)
                return {"targets": trandom.normal(tkey, (1,))}

            def step_fn(model, opt_state, batch):
                model, opt_state, info = gnn_train_step(
                    model, opt_state,
                    lambda p: nequip_mod.nequip_loss(
                        p, mcfg, species, coords, g.senders, g.receivers,
                        batch["targets"]), ocfg)
                return model, opt_state, info["loss"]

            return model, optim.init_adam(model.params()), step_fn, data_fn

        d_in, n_classes = 16, 4
        mcfg = dataclasses.replace(mcfg, d_in=d_in, n_classes=n_classes)
        feats = trandom.normal(fkey, (n1, d_in))
        coords = trandom.normal(ckey, (n1, 3))
        labels = trandom.randint(trandom.fold_in(key, 3), (g.n,), 0,
                                 n_classes)
        model = gnn_mod.init_gnn(mcfg, key=key)

        def data_fn(step):
            return {}

        def step_fn(model, opt_state, batch):
            model, opt_state, info = gnn_train_step(
                model, opt_state,
                lambda p: gnn_mod.gnn_loss(
                    p, mcfg, feats, g.senders, g.receivers, labels,
                    coords=coords if mcfg.kind == "egnn" else None), ocfg)
            return model, opt_state, info["loss"]

        return model, optim.init_adam(model.params()), step_fn, data_fn
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
