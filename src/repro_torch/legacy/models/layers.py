"""Shared neural-network layers (mirrors ``repro.legacy.models.layers``).

Weights keep the reference's ``(d_in, d_out)`` layout, so that a layer
computes ``x @ w + b`` as the reference does and its weights carry across
without a transpose. The initializers draw from a threefry ``key``
(``repro_torch.random``: the reference's weights for the reference's key)
or from a ``torch.Generator`` (torch's numbers).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ... import random as trandom


def normal(shape: tuple, *, key=None, generator=None,
           device=None) -> torch.Tensor:
    """A float32 standard normal draw of ``shape``: ``jax.random.normal``'s
    from ``key`` (on the key's device), else ``torch.randn``'s from
    ``generator`` on ``device``; one of the two."""
    if (key is None) == (generator is None):
        raise ValueError("pass one of key= and generator=")
    if key is not None:
        return trandom.normal(key, shape)
    return torch.randn(*shape, generator=generator, device=device,
                       dtype=torch.float32)


def dense_init(d_in: int, d_out: int, *, key=None, generator=None,
               device=None, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """A ``(d_in, d_out)`` normal weight scaled by ``1/sqrt(d_in)``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = normal((d_in, d_out), key=key, generator=generator, device=device)
    return (w * scale).to(dtype)


class MLP(nn.Module):
    """``x @ w_i + b_i`` per layer with ReLU between layers, and after the
    last one too when ``final_relu`` (the reference's ``mlp_apply`` with
    ``act=relu``, ``final_act=relu`` or ``None``). Trainable: ``params()``
    is the reference's ``{"w0", "b0", ...}`` pytree of its parameters."""

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor], *, final_relu: bool):
        super().__init__()
        if len(weights) != len(biases) or not weights:
            raise ValueError(f"an MLP needs as many biases as weights, at "
                             f"least one: {len(weights)} / {len(biases)}")
        self.weights = nn.ParameterList(weights)
        self.biases = nn.ParameterList(biases)
        self.final_relu = final_relu

    @classmethod
    def from_params(cls, params: Mapping[str, np.ndarray], *,
                    final_relu: bool, device) -> "MLP":
        """From the reference's ``{"w0", "b0", ...}`` pytree, as arrays."""
        n = len(params) // 2
        return cls([torch.tensor(np.asarray(params[f"w{i}"]), device=device)
                    for i in range(n)],
                   [torch.tensor(np.asarray(params[f"b{i}"]), device=device)
                    for i in range(n)], final_relu=final_relu)

    def params(self) -> dict:
        """``{"w{i}": weight, "b{i}": bias}``: the parameters themselves."""
        out = {f"w{i}": w for i, w in enumerate(self.weights)}
        out.update({f"b{i}": b for i, b in enumerate(self.biases)})
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = torch.addmm(b.to(x.dtype), x, w.to(x.dtype))
            if i < last or self.final_relu:
                x = torch.relu(x)
        return x


def mlp_init(sizes: Sequence[int], *, key=None, generator=None, device=None,
             dtype=torch.float32, final_relu: bool = False) -> MLP:
    """Layers ``sizes[0] → sizes[1] → …``: normal weights, zero biases. From
    a ``key``, layer ``i`` draws from ``split(key, len(sizes) - 1)[i]`` as
    the reference's ``mlp_init`` does."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    if key is not None:
        device = key.device
        ws = [dense_init(a, b, key=k, dtype=dtype)
              for (a, b), k in zip(pairs, trandom.split(key, len(pairs)))]
    else:
        ws = [dense_init(a, b, generator=generator, device=device,
                         dtype=dtype) for a, b in pairs]
    bs = [torch.zeros(b, device=device, dtype=dtype) for b in sizes[1:]]
    return MLP(ws, bs, final_relu=final_relu)
