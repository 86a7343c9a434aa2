"""Shared neural-network layers (mirrors ``repro.legacy.models.layers``).

Weights keep the reference's ``(d_in, d_out)`` layout, so that a layer
computes ``x @ w + b`` as the reference does and its weights carry across
without a transpose. The initializers draw from a threefry ``key``
(``repro_torch.random``: the reference's weights for the reference's key)
or from a ``torch.Generator`` (torch's numbers).
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ... import random as trandom
from ..tree import flatten


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


def mlp_params(sizes: Sequence[int], *, key, dtype=torch.float32) -> dict:
    """The reference's ``mlp_init(key, sizes, dtype)`` pytree ``{"w0",
    "b0", ...}`` as tensors on the key's device: layer ``i``'s weight from
    ``split(key, len(sizes) - 1)[i]``, biases zero."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    keys = trandom.split(key, len(pairs))
    out = {f"w{i}": dense_init(a, b, key=keys[i], dtype=dtype)
           for i, (a, b) in enumerate(pairs)}
    out.update({f"b{i}": torch.zeros(b, dtype=dtype, device=key.device)
                for i, (_, b) in enumerate(pairs)})
    return out


def mlp_shapes(sizes: Sequence[int]) -> dict:
    """The leaf shapes of ``mlp_params(sizes)``."""
    out = {f"w{i}": (a, b) for i, (a, b) in enumerate(zip(sizes[:-1],
                                                            sizes[1:]))}
    out.update({f"b{i}": (b,) for i, b in enumerate(sizes[1:])})
    return out


def mlp_apply(params: Mapping, x: torch.Tensor, *,
              act: Callable = torch.relu, final_act: Optional[Callable] = None,
              n_layers: Optional[int] = None) -> torch.Tensor:
    """The reference's ``mlp_apply``: ``x @ w_i + b_i`` with the weights
    and biases cast to ``x``'s dtype, ``act`` between layers and
    ``final_act`` (if any) after the last."""
    n = n_layers if n_layers is not None else len(params) // 2
    for i in range(n):
        x = x @ params[f"w{i}"].to(x.dtype) + params[f"b{i}"].to(x.dtype)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def top_k(x: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k``: ``(values, indices)`` of the ``k`` largest along
    the last axis, largest first, ties to the lower index (a stable
    descending sort; ``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the two operands' promoted dtype, as ``jnp`` promotes a
    bfloat16 activation against a float32 weight (to float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


class ParamTree(nn.Module):
    """A model whose parameters are the reference's pytree: the leaves are
    ``nn.Parameter``s in the reference's leaf order, ``params()`` the
    pytree of those tensors themselves (which ``legacy.optim`` updates in
    place and ``legacy.checkpoint`` saves in that order)."""

    def __init__(self, params: Mapping):
        super().__init__()
        leaves, rebuild = flatten(dict(params))
        self._leaves = nn.ParameterList(
            [x if isinstance(x, nn.Parameter) else nn.Parameter(x)
             for x in leaves])
        self._rebuild = rebuild

    @staticmethod
    def tensors(params: Mapping, *, device) -> dict:
        """A pytree of arrays (the reference's, as numpy) as tensors on
        ``device``."""
        leaves, rebuild = flatten(dict(params))
        return rebuild([torch.tensor(np.asarray(x), device=device)
                        for x in leaves])

    def params(self) -> dict:
        return self._rebuild(list(self._leaves))


# ---------------------------------------------------------------------------
# The transformer's layers (the reference's ``no_shard``, ``rms_norm``,
# RoPE and chunked attention).
# ---------------------------------------------------------------------------

def no_shard(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    """The reference's identity sharding hint (one rank places nothing)."""
    return x


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a float32 divide on every device: CUDA multiplies by
    the reciprocal of a host scalar, so the divisor goes as a tensor."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast to ``x``'s dtype, then multiply by
    ``gamma`` in that dtype: the reference's cast order, on which the
    bfloat16 bits depend."""
    dtype = x.dtype
    x = x.float()
    scale = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale).to(dtype) * gamma.to(dtype)


def rope_frequencies(d_head: int, theta: float = 1e4,
                     device=None) -> torch.Tensor:
    """``1 / theta ** (2i / d_head)``, float32, ``(d_head // 2,)``."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: (..., S). Rotates the two halves
    of each head in float32 and casts back to ``x``'s dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class _CardScores(torch.autograd.Function):
    """``q @ k^T`` of two bfloat16 operands on the card, with a float32
    output (``bmm``'s ``out_dtype``, for which autograd has no formula);
    the backward runs in float32 and casts each gradient to its operand's
    dtype."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return torch.bmm(q, k.transpose(-1, -2), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        return (torch.bmm(g, k.float()).to(q.dtype),
                torch.bmm(g.transpose(-1, -2), q.float()).to(k.dtype))


def scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q @ k^T`` of (N, M, d) and (N, K, d), accumulated and returned in
    float32 (the reference's ``preferred_element_type=float32``). A product
    of two bfloat16 values is exact in float32: the card takes bfloat16
    inputs with a float32 output, the CPU float32 copies."""
    if q.dtype == torch.float32:
        return torch.bmm(q, k.transpose(-1, -2))
    if q.is_cuda:
        return _CardScores.apply(q, k)
    return torch.bmm(q.float(), k.float().transpose(-1, -2))


NEG = -1e30  # the masked score


def _pad_to(x: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    p = s - x.shape[dim]
    if p == 0:
        return x
    shape = list(x.shape)
    shape[dim] = p
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


# score elements one pass of ``chunked_attention`` holds at most: the
# query chunks of a pass are as many as keep B x H x rows x k_chunk float32
# scores within it (at least one chunk): 4 GiB a block, the whole of a
# 32k prompt's queries against a key chunk at B = 1
SCORE_BUDGET = 1 << 30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset=0, q_chunk: int = 1024,
                      k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention with GQA head grouping (the reference's
    ``chunked_attention``): q (B, Sq, Hq, dh), k and v (B, Sk, Hkv, dh).

    Queries and keys are padded to chunk multiples and each query chunk
    runs over the key chunks in order, carrying float32 ``(acc, row_max,
    row_sum)``, with the causal and sliding-window masks, ``q_offset`` (the
    absolute position of ``q[0]``, an int or a 0-d tensor) and the
    ``-1e30`` fill. The reference maps over the query chunks one at a time;
    here a pass takes as many query chunks at once as ``SCORE_BUDGET``
    allows. Each query row's arithmetic is the same either way. A key chunk
    whose every pair is valid skips the mask (``where`` of all true is the
    identity); a fully masked chunk is computed, as the reference's is.
    Traced as the profiler range ``lm.attention``."""
    with torch.profiler.record_function("lm.attention"):
        return _chunked_attention(q, k, v, causal, window, q_offset,
                                  q_chunk, k_chunk)


def _chunked_attention(q, k, v, causal, window, q_offset, q_chunk,
                       k_chunk):
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = float(np.float32(1.0 / np.sqrt(dh)))
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // k_chunk)
    # (B * Hkv, g, nq * qc, dh); keys and values (B * Hkv, nk * kc, dh)
    qp = _pad_to(q, nq * q_chunk, 1).reshape(B, nq * q_chunk, Hkv, g, dh) \
        .permute(0, 2, 3, 1, 4).reshape(B * Hkv, g, nq * q_chunk, dh)
    kp = _pad_to(k, nk * k_chunk, 1).permute(0, 2, 1, 3) \
        .reshape(B * Hkv, nk * k_chunk, dh)
    vp = _pad_to(v, nk * k_chunk, 1).permute(0, 2, 1, 3) \
        .reshape(B * Hkv, nk * k_chunk, dh)
    host_offset = not isinstance(q_offset, torch.Tensor)
    dev = q.device
    per = max(1, SCORE_BUDGET // (B * Hq * q_chunk * k_chunk))
    outs = []
    for c0 in range(0, nq, per):
        c1 = min(nq, c0 + per)
        rows = (c1 - c0) * q_chunk
        # a pass's rows: g heads of each kv head, one after the other
        q_blk = qp[:, :, c0 * q_chunk: c1 * q_chunk].reshape(
            B * Hkv, g * rows, dh)
        q_pos = q_offset + c0 * q_chunk + torch.arange(rows, device=dev)
        acc = torch.zeros((B * Hkv, g * rows, dh), dtype=torch.float32,
                          device=dev)
        mx = torch.full((B * Hkv, g * rows), NEG, dtype=torch.float32,
                        device=dev)
        sm = torch.zeros((B * Hkv, g * rows), dtype=torch.float32,
                         device=dev)
        for ki in range(nk):
            lo = ki * k_chunk
            s = scores(q_blk, kp[:, lo: lo + k_chunk]) * scale
            if not (host_offset and _all_valid(
                    q_offset + c0 * q_chunk, rows, lo, k_chunk, Sk, causal,
                    window)):
                k_pos = lo + torch.arange(k_chunk, device=dev)
                mask = (k_pos[None, :] <= Sk - 1).expand(rows, k_chunk)
                if causal:
                    mask = mask & (k_pos[None, :] <= q_pos[:, None])
                if window is not None:
                    mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
                s = torch.where(mask, s.view(B * Hkv, g, rows, k_chunk),
                                NEG).view(B * Hkv, g * rows, k_chunk)
            new_mx = torch.maximum(mx, s.amax(-1))
            corr = torch.exp(mx - new_mx)
            p = torch.exp(s - new_mx[..., None])
            sm = sm * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.bmm(
                p, vp[:, lo: lo + k_chunk].float())
            mx = new_mx
        out = acc / torch.clamp(sm[..., None], min=1e-30)
        outs.append(out.view(B * Hkv, g, rows, dh))
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    # (B, Hkv, g, rows, dh) -> (B, rows, Hkv, g, dh) -> (B, Sq, Hq, dh)
    out = out.view(B, Hkv, g, nq * q_chunk, dh).permute(0, 3, 1, 2, 4) \
        .reshape(B, nq * q_chunk, Hq, dh)
    return out[:, :Sq].to(q.dtype)


def _all_valid(q0: int, rows: int, k0: int, kc: int, sk: int, causal: bool,
               window: Optional[int]) -> bool:
    """Whether every (query, key) pair of a block passes the masks: query
    positions ``[q0, q0 + rows)``, key positions ``[k0, k0 + kc)``."""
    if k0 + kc - 1 > sk - 1:
        return False
    if causal and k0 + kc - 1 > q0:
        return False
    if window is not None and k0 <= q0 + rows - 1 - window:
        return False
    return True


def dot_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """O(S²) attention in float32 (the reference's oracle for
    ``chunked_attention``)."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = div(s, float(np.sqrt(dh)))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos[None] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None] > q_pos[:, None] - window)
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)
