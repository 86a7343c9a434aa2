"""Deterministic measurement harness: the tuner's timing discipline.

``time_fn`` is the port's wall-clock helper, as ``repro.tune.harness``'s
is the reference's. Discipline:

* explicit ``warmup`` runs first (kernel builds and cache effects
  excluded);
* on a CUDA ``device``, ``torch.cuda.synchronize`` after every warmup call,
  before each sample's first clock read and after each call: PyTorch
  returns before the card finishes, so without it the clock measures the
  enqueue (the reference blocks on every result with
  ``jax.block_until_ready``);
* the **median** of ``trials`` samples (robust to scheduler noise);
* an injectable ``timer`` (default ``time.perf_counter``), read before and
  after each timed call exactly as the reference reads its own, so that a
  scripted fake clock picks the same winners in both packages.

``primitive_drivers`` builds one closure per connectivity hot-path op over
one problem made from the seed (the reference's: a parent forest
``P[i] <= i`` and uniform edges), each taking the block size, so the same
drivers serve the block-size tuner and the checks of the ladder.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .space import TuneSpec

__all__ = ["time_fn", "primitive_problem", "primitive_drivers",
           "measure_primitives", "PRIMITIVES", "PRIMITIVE_LABELS"]

# tuning targets: every hot-path op with a block-gridded kernel
PRIMITIVES = ("scatter_min", "pointer_jump", "hook_compress",
              "edge_relabel", "edge_rewrite")

# display labels (the reference's roofline table's names)
PRIMITIVE_LABELS = {
    "scatter_min": "scatter_min (writeMin)",
    "pointer_jump": "pointer_jump k=3 (FindHalve)",
    "hook_compress": "hook_compress k=1 (uf_sync round)",
    "edge_relabel": "edge_relabel (ParentConnect)",
    "edge_rewrite": "edge_rewrite (alter/stream)",
}


def time_fn(fn: Callable, *args, trials: int = 3, warmup: int = 1,
            timer: Optional[Callable[[], float]] = None, device=None,
            **kw) -> float:
    """Median wall time in seconds of ``fn(*args, **kw)``.

    Runs ``warmup`` discarded calls, then ``trials`` timed calls; ``timer``
    is read before and after each timed call. With a CUDA ``device`` the
    card is synchronized around every call, so that a sample holds the
    call's device work."""
    if trials < 1:
        raise ValueError(f"trials must be >= 1, got {trials}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    clock = time.perf_counter if timer is None else timer
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda":
        def sync():
            torch.cuda.synchronize(dev)
    else:
        def sync():
            pass
    for _ in range(warmup):
        fn(*args, **kw)
        sync()
    samples = []
    for _ in range(trials):
        sync()
        t0 = clock()
        fn(*args, **kw)
        sync()
        samples.append(clock() - t0)
    return float(np.median(samples))


def primitive_problem(n: int, m: int, *, seed: int = 0,
                      device=DEFAULT_DEVICE) -> tuple:
    """``(P, s, r, vals)`` on ``device``: a valid parent forest
    (``P[i] <= i``, ``(n + 1,)``) and uniform edges and values ``(m,)``,
    int32, drawn with numpy from ``seed`` in the reference's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    arrays = (np.minimum(rng.integers(0, n, n + 1), np.arange(n + 1)),
              rng.integers(0, n, m), rng.integers(0, n, m),
              rng.integers(0, n, m))
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev) for a in arrays)


def primitive_drivers(n: int, m: int, *, seed: int = 0,
                      device=DEFAULT_DEVICE) -> dict:
    """``{primitive: driver}`` over one ``primitive_problem``, where
    ``driver(block_m=None)`` dispatches the op once through
    ``repro_torch.kernels.ops`` (the CUDA kernel on a CUDA device, which
    refuses a ``block_m`` off the ladder; the plain version on the CPU,
    which ignores it) and returns its result."""
    from ..kernels import ops

    P, s, r, vals = primitive_problem(n, m, seed=seed, device=device)
    return {
        "scatter_min": lambda block_m=None: ops.scatter_min(
            P, s, vals, block_m=block_m),
        "pointer_jump": lambda block_m=None: ops.pointer_jump(
            P, k=3, block_m=block_m),
        "hook_compress": lambda block_m=None: ops.hook_compress(
            P, s, r, k=1, block_m=block_m),
        "edge_relabel": lambda block_m=None: ops.edge_relabel(
            P, s, r, block_m=block_m),
        "edge_rewrite": lambda block_m=None: ops.edge_rewrite(
            P, s, r, block_m=block_m),
    }


def measure_primitives(*, n: int, m: int, spec: TuneSpec = TuneSpec(),
                       primitives: Optional[Sequence[str]] = None,
                       block_m: Optional[int] = None,
                       timer: Optional[Callable[[], float]] = None,
                       seed: int = 0, device=DEFAULT_DEVICE) -> list:
    """Time every primitive under the harness discipline.

    Returns rows ``{"primitive", "policy", "block_m", "time_s"}``, the
    reference's; ``policy`` is always ``"auto"``: the port dispatches by
    tensor device."""
    drivers = primitive_drivers(n, m, seed=seed, device=device)
    names = PRIMITIVES if primitives is None else tuple(primitives)
    rows = []
    for name in names:
        t = time_fn(drivers[name], block_m=block_m, trials=spec.trials,
                    warmup=spec.warmup, timer=timer, device=device)
        rows.append(dict(primitive=name, policy="auto", block_m=block_m,
                         time_s=t))
    return rows
