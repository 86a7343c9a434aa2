"""ServeConfig: the admission/coalescing knobs of the serving subsystem.

One frozen dataclass with the JAX package's knobs, defaults and validation
messages (``repro.serve.config``): every knob is checked at construction,
before any device buffer is allocated.

Knob semantics:

  * ``max_batch_edges`` / ``max_batch_queries`` — the coalescer's admission
    caps: a device dispatch is cut as soon as the pending work reaches the
    cap (a single oversized request still dispatches whole — the pow2
    bucketing absorbs the shape). Bigger caps trade tail latency for
    throughput.
  * ``flush_ms`` — the max-latency flush timer: a request never waits
    longer than this for co-batched traffic before its partial batch is
    dispatched. ``0`` flushes immediately (batch = whatever is pending the
    moment the coalescer wakes).
  * ``max_pending_edges`` — queue-depth backpressure: ``submit_inserts``
    blocks (awaits) while this many edges are already queued or in an
    uncommitted batch, bounding memory and commit lag under overload.
  * ``donate`` — hand the shadow buffer's memory to the next epoch: the
    snapshot store drops its reference to the shadow before the commit
    allocates, so the caching allocator can reuse its block for the
    commit's buffers. Off, the shadow is held until the rotation. The
    epochs and labels are the same either way.
  * ``warmup`` — exercise the dispatch shapes at server start on scratch
    buffers, so that no client request pays for a kernel build (nvcc at
    first use) or a cold allocator, and the live state is NOT perturbed:
    no epoch, label or counter of the served state moves. ``True`` warms
    the admission caps' shapes, ``"all"`` every pow2 bucket up to the caps,
    ``False`` nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Union

__all__ = ["ServeConfig"]

WARMUP_MODES = (False, True, "all")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Admission + coalescing policy for ``repro_torch.serve.Server``."""

    max_batch_edges: int = 4096     # admission cap per insert commit
    max_batch_queries: int = 4096   # admission cap per query dispatch
    flush_ms: float = 1.0           # max-latency flush timer (milliseconds)
    max_pending_edges: int = 1 << 16  # backpressure threshold (queue depth)
    donate: bool = False            # double-buffer rotation via donation
    warmup: Union[bool, str] = True  # precompile shapes: False | True | "all"

    def __post_init__(self):
        if self.warmup not in WARMUP_MODES:
            raise ValueError(f"warmup must be one of {WARMUP_MODES}, "
                             f"got {self.warmup!r}")
        for name in ("max_batch_edges", "max_batch_queries",
                     "max_pending_edges"):
            v = getattr(self, name)
            if int(v) != v or int(v) < 1:
                raise ValueError(f"{name} must be a positive integer, "
                                 f"got {v!r}")
            object.__setattr__(self, name, int(v))
        object.__setattr__(self, "flush_ms", float(self.flush_ms))
        if self.flush_ms < 0:
            raise ValueError(f"flush_ms must be >= 0, got {self.flush_ms}")
        if self.max_pending_edges < self.max_batch_edges:
            raise ValueError(
                f"max_pending_edges ({self.max_pending_edges}) must be >= "
                f"max_batch_edges ({self.max_batch_edges}) or the admission "
                f"queue can never fill a batch")

    @property
    def flush_s(self) -> float:
        return self.flush_ms / 1e3
