"""Wrappers of the hand-written CUDA edge_relabel and edge_rewrite
(``csrc/edge_relabel.cu``, one library with two entry points).

Each takes int32 tensors on one CUDA device and raises on anything else;
``edge_relabel.launches`` and ``edge_rewrite.launches`` count their calls.
"""

from __future__ import annotations

import torch

from .. import _build


def edge_relabel(labels: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor) -> torch.Tensor:
    """One relabel round out of place: ``out[r] min= labels[s]`` and
    ``out[s] min= labels[r]``, gathers from the input labels."""
    _build.check_args("edge_relabel", labels, senders, receivers)
    out = torch.empty_like(labels)
    lib = _build.load("edge_relabel")
    rc = lib.edge_relabel_i32(labels.data_ptr(), senders.data_ptr(),
                              receivers.data_ptr(), out.data_ptr(),
                              labels.numel(), senders.numel(),
                              _build.stream_of(labels))
    _build.check(rc, "edge_relabel")
    edge_relabel.launches += 1
    return out


def _at_phase_of(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor like ``x`` that starts as far past a 16-byte boundary
    as ``x`` does (a view 0-3 elements into a slightly longer buffer), so
    that a kernel streaming both takes 16-byte vectors."""
    phase = x.data_ptr() % 16 // x.element_size()
    if phase == 0:
        return torch.empty_like(x)
    k = x.numel()
    return x.new_empty(k + 3)[phase: phase + k]


def edge_rewrite(labels: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor):
    """``(labels[s], labels[r])`` with negative endpoints kept; each output
    at its input's 16-byte phase."""
    _build.check_args("edge_rewrite", labels, senders, receivers)
    s_out = _at_phase_of(senders)
    r_out = _at_phase_of(receivers)
    lib = _build.load("edge_relabel")
    rc = lib.edge_rewrite_i32(labels.data_ptr(), senders.data_ptr(),
                              receivers.data_ptr(), s_out.data_ptr(),
                              r_out.data_ptr(), labels.numel(),
                              senders.numel(), _build.stream_of(labels))
    _build.check(rc, "edge_rewrite")
    edge_rewrite.launches += 1
    return s_out, r_out


edge_relabel.launches = 0
edge_rewrite.launches = 0
