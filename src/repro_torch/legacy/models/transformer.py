"""Decoder-only transformer LM (dense + MoE) with GQA, RoPE, SWA and
qk-norm (mirrors ``repro.legacy.models.transformer`` on one rank).

One model covers the five LM archs. The parameters keep the reference's
pytree: ``{"embed", "layers", "final_norm", "lm_head"}`` with every layer
leaf stacked along a leading ``L`` axis, one tensor a leaf, float32; a
forward walks the layers in a Python loop over views of the stacked leaves
(``unbind``, whose backward writes each leaf's gradient once). Activations
run in ``cfg.dtype``, and every weight is cast to it at each use, as the
reference's ``.astype(act_dtype)`` does.

Entry points (functions of the pytree, and methods of ``Transformer``,
whose ``params()`` is that pytree of its own parameters):
  * ``lm_loss(params, tokens, labels, cfg)``   — training forward + xent
  * ``prefill(params, tokens, cfg, max_len)``  — KV caches + last logits
  * ``decode_step(params, cache, token, cfg)`` — one-token serve step;
    it writes the new key and value into ``cache`` in place (the
    reference's functional update returns a new cache), so a cache passed
    to it is consumed

``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
non-reentrant), as the reference's ``jax.checkpoint`` does.
"""

from __future__ import annotations

import dataclasses
from math import prod
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ... import random as trandom
from ..tree import flatten
from .layers import apply_rope, chunked_attention, dense_init, div, no_shard
from .layers import rms_norm
from .moe import MoEConfig, moe_apply, moe_init
from .moe import param_shapes as moe_shapes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 → d_model // n_heads
    qk_norm: bool = False
    swa_window: Optional[int] = None     # sliding-window attention width
    rope_theta: float = 1e4
    # MoE (n_experts == 0 → dense SwiGLU FFN)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1        # MoE dispatch groups (= data shards on mesh)
    moe_fsdp: bool = True      # FSDP-gather expert weights (train cells)
    moe_a2a_int8: bool = False # int8-compressed EP all_to_all (mesh only)
    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    q_chunk: int = 512
    k_chunk: int = 1024

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(self.d_model, self.d_expert or self.d_ff,
                         self.n_experts, self.top_k, self.n_shared_experts,
                         self.capacity_factor, self.moe_groups,
                         self.moe_a2a_int8)

    @property
    def act_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def param_count(self) -> int:
        """The reference's count (its formula: routed experts unpadded, no
        qk-norm gains)."""
        D, dh = self.d_model, self.head_dim
        att = D * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.is_moe:
            F_ = self.d_expert or self.d_ff
            ffn = self.n_experts * 3 * D * F_ + D * self.n_experts
            ffn += self.n_shared_experts * 3 * D * F_
        else:
            ffn = 3 * D * self.d_ff
        per_layer = att + ffn + 2 * D
        return self.n_layers * per_layer + 2 * self.vocab * D + D


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

def layer_shapes(cfg: TransformerConfig) -> dict:
    """One layer's leaves' shapes (``_layer_init``'s pytree)."""
    D, dh = cfg.d_model, cfg.head_dim
    p = {"ln_attn": (D,), "ln_ffn": (D,),
         "wq": (D, cfg.n_heads * dh), "wk": (D, cfg.n_kv_heads * dh),
         "wv": (D, cfg.n_kv_heads * dh), "wo": (cfg.n_heads * dh, D)}
    if cfg.qk_norm:
        p["q_norm"] = (dh,)
        p["k_norm"] = (dh,)
    if cfg.is_moe:
        p["moe"] = moe_shapes(cfg.moe_cfg)
    else:
        p["ffn"] = {"w_gate": (D, cfg.d_ff), "w_up": (D, cfg.d_ff),
                    "w_down": (cfg.d_ff, D)}
    return p


def _stacked(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    return (n,) + tuple(tree)


def param_shapes(cfg: TransformerConfig) -> dict:
    """Every leaf's shape of ``init_params``' pytree."""
    return {"embed": (cfg.vocab, cfg.d_model),
            "layers": _stacked(layer_shapes(cfg), cfg.n_layers),
            "final_norm": (cfg.d_model,),
            "lm_head": (cfg.d_model, cfg.vocab)}


def shape_leaves(tree) -> list:
    """A pytree of shapes' leaves in the reference's order (keys sorted)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in shape_leaves(tree[k])]
    return [tuple(tree)]


def param_bytes(cfg: TransformerConfig) -> int:
    """The float32 parameters' bytes."""
    return 4 * sum(prod(s) for s in shape_leaves(param_shapes(cfg)))


def _layer_init(key: torch.Tensor, cfg: TransformerConfig) -> dict:
    ks = trandom.split(key, 6)
    D, dh = cfg.d_model, cfg.head_dim
    ones = dict(dtype=torch.float32, device=key.device)
    p = {
        "ln_attn": torch.ones(D, **ones),
        "ln_ffn": torch.ones(D, **ones),
        "wq": dense_init(D, cfg.n_heads * dh, key=ks[0]),
        "wk": dense_init(D, cfg.n_kv_heads * dh, key=ks[1]),
        "wv": dense_init(D, cfg.n_kv_heads * dh, key=ks[2]),
        "wo": dense_init(cfg.n_heads * dh, D, key=ks[3]),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, **ones)
        p["k_norm"] = torch.ones(dh, **ones)
    if cfg.is_moe:
        p["moe"] = moe_init(ks[4], cfg.moe_cfg)
    else:
        sk = trandom.split(ks[4], 3)
        p["ffn"] = {
            "w_gate": dense_init(D, cfg.d_ff, key=sk[0]),
            "w_up": dense_init(D, cfg.d_ff, key=sk[1]),
            "w_down": dense_init(cfg.d_ff, D, key=sk[2]),
        }
    return p


def init_params(key: torch.Tensor, cfg: TransformerConfig) -> dict:
    """The reference's ``init_params(key, cfg)`` (float32), drawn on the
    key's device: layer ``l`` draws from ``split(split(key, 4)[1], L)[l]``
    (the reference's ``vmap`` over the layer keys draws what one call a key
    draws) straight into its slice of each stacked leaf."""
    k_embed, k_layers, k_head, _ = trandom.split(key, 4)
    layer_keys = trandom.split(k_layers, cfg.n_layers)
    for i in range(cfg.n_layers):
        leaves, rebuild = flatten(_layer_init(layer_keys[i], cfg))
        if i == 0:
            stacked = [torch.empty((cfg.n_layers,) + tuple(x.shape),
                                   dtype=x.dtype, device=x.device)
                       for x in leaves]
            layers = rebuild(stacked)
        for dst, src in zip(stacked, leaves):
            dst[i].copy_(src)
        del leaves
    return {
        "embed": dense_init(cfg.vocab, cfg.d_model, key=k_embed, scale=1.0),
        "layers": layers,
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=key.device),
        "lm_head": dense_init(cfg.d_model, cfg.vocab, key=k_head),
    }


# ---------------------------------------------------------------------------
# The forward pass.
# ---------------------------------------------------------------------------

def _w(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 weight cast to the activation dtype at its use (the
    reference's ``.astype``), traced as the profiler range
    ``lm.weight_cast``."""
    with torch.profiler.record_function("lm.weight_cast"):
        return w.to(dtype)


def _qkv(p: dict, x: torch.Tensor, positions: torch.Tensor,
         cfg: TransformerConfig, shard) -> tuple:
    """A block's queries, keys and values after qk-norm and RoPE."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    h = rms_norm(x, p["ln_attn"])
    q = (h @ _w(p["wq"], h.dtype)).reshape(B, S, cfg.n_heads, dh)
    k = (h @ _w(p["wk"], h.dtype)).reshape(B, S, cfg.n_kv_heads, dh)
    v = (h @ _w(p["wv"], h.dtype)).reshape(B, S, cfg.n_kv_heads, dh)
    q = shard(q, ("data", None, "model", None))
    k = shard(k, ("data", None, "model", None))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(p: dict, x: torch.Tensor, q, k, v, cfg: TransformerConfig,
              shard) -> torch.Tensor:
    B, S, _ = x.shape
    o = chunked_attention(q, k, v, causal=True, window=cfg.swa_window,
                          q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return x + shard(o @ _w(p["wo"], o.dtype), ("data", None, None))


def _ffn(p: dict, x: torch.Tensor, cfg: TransformerConfig, shard) -> tuple:
    B, S, D = x.shape
    h = rms_norm(x, p["ln_ffn"])
    if cfg.is_moe:
        y, aux = moe_apply(p["moe"], h.reshape(B * S, D), cfg.moe_cfg, shard)
        return x + y.reshape(B, S, D), aux
    f = p["ffn"]
    h1 = F.silu(h @ _w(f["w_gate"], h.dtype))
    h2 = h @ _w(f["w_up"], h.dtype)
    h12 = shard(h1 * h2, ("data", None, "model"))
    y = h12 @ _w(f["w_down"], h.dtype)
    return x + shard(y, ("data", None, None)), x.new_zeros((), dtype=torch.float32)


def _block(p: dict, x: torch.Tensor, positions: torch.Tensor,
           cfg: TransformerConfig, shard) -> tuple:
    q, k, v = _qkv(p, x, positions, cfg, shard)
    x = _attn_out(p, x, q, k, v, cfg, shard)
    return _ffn(p, x, cfg, shard)


def layer_views(params: dict, cfg: TransformerConfig) -> list:
    """The ``L`` layers' pytrees of views into the stacked leaves."""
    leaves, rebuild = flatten(params["layers"])
    per = [x.unbind(0) for x in leaves]
    return [rebuild([p[i] for p in per]) for i in range(cfg.n_layers)]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def embed(params: dict, tokens: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """The token embeddings in the activation dtype: the table cast at use,
    then gathered (the reference's order), through ``F.embedding``, whose
    backward sums each row's gradients in a fixed order on the CPU and on
    the card (a sort, then one pass a row): a step's gradient is the same
    bits every run. Plain indexing's backward (``index_put_`` with
    ``accumulate``) adds them in a varying order on the CPU."""
    return F.embedding(tokens, params["embed"].to(cfg.act_dtype))


def forward_hidden(params: dict, tokens: torch.Tensor,
                   cfg: TransformerConfig, shard=no_shard) -> tuple:
    """tokens (B, S) int → final hidden states (B, S, D) + MoE aux loss."""
    B, S = tokens.shape
    x = embed(params, tokens, cfg)
    positions = _positions(B, S, tokens.device)
    x = shard(x, ("data", "seq", None))
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for lp in layer_views(params, cfg):
        if cfg.remat:
            x, a = checkpoint(
                lambda x, lp=lp: _block(lp, x, positions, cfg, shard), x,
                use_reentrant=False)
        else:
            x, a = _block(lp, x, positions, cfg, shard)
        x = shard(x, ("data", "seq", None))
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    return x, div(aux, float(cfg.n_layers))


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            shard=no_shard) -> tuple:
    """tokens (B, S) int → logits (B, S, vocab) + aux loss."""
    x, aux = forward_hidden(params, tokens, cfg, shard)
    return x @ _w(params["lm_head"], x.dtype), aux


def sharded_xent(x: torch.Tensor, lm_head: torch.Tensor,
                 labels: torch.Tensor, shard=no_shard) -> torch.Tensor:
    """Per-token NLL (B, S): a float32 logsumexp less the label's logit,
    taken by a masked reduction over the vocab, never a gather (a label < 0
    picks nothing)."""
    logits = x @ _w(lm_head, x.dtype)
    logits = shard(logits, ("data", None, "model")).float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    iota = torch.arange(logits.shape[-1], device=logits.device)
    label_logit = torch.sum(
        torch.where(iota == labels[..., None], logits, 0.0), dim=-1)
    return lse - label_logit


def lm_loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig, shard=no_shard,
            aux_weight: float = 0.01) -> tuple:
    """``(mean nll over labels >= 0 + aux_weight * aux, {"nll", "aux"})``."""
    x, aux = forward_hidden(params, tokens, cfg, shard)
    nll = sharded_xent(x, params["lm_head"], labels, shard)
    mask = labels >= 0
    loss = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with (ring-buffered) KV caches.
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor     # (L, B, S_cache, Hkv, dh): a ring buffer iff SWA
    v: torch.Tensor
    pos: torch.Tensor   # () int32: the tokens already absorbed

    @property
    def size(self) -> int:
        return self.k.shape[2]


def _cache_shape(cfg: TransformerConfig, batch: int, max_len: int) -> tuple:
    s_cache = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    return (cfg.n_layers, batch, s_cache, cfg.n_kv_heads, cfg.head_dim)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
               device) -> KVCache:
    shape = _cache_shape(cfg, batch, max_len)
    return KVCache(torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                   torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def cache_spec(cfg: TransformerConfig, batch: int, max_len: int) -> KVCache:
    """``init_cache``'s shapes as ``meta`` tensors."""
    shape = _cache_shape(cfg, batch, max_len)
    meta = dict(dtype=cfg.act_dtype, device="meta")
    return KVCache(torch.empty(shape, **meta), torch.empty(shape, **meta),
                   torch.empty((), dtype=torch.int32, device="meta"))


def _decode_attn(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, pos: torch.Tensor,
                 cfg: TransformerConfig, shard) -> torch.Tensor:
    """One-token attention against a (ring) cache. x: (B, 1, D). Writes the
    token's key and value into slot ``pos % S_cache`` of ``cache_k`` and
    ``cache_v`` (B, S_cache, Hkv, dh) in place."""
    B = x.shape[0]
    dh = cfg.head_dim
    S_c = cache_k.shape[1]
    positions = pos.to(torch.int32).expand(B, 1)
    q, k, v = _qkv(p, x, positions, cfg, no_shard)
    slot = (pos.to(torch.int64) % S_c).reshape(1)  # ring slot (== pos when full-length)
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    # score against every cache slot; mask unwritten slots
    with torch.profiler.record_function("lm.attention"):
        g = cfg.n_heads // cfg.n_kv_heads
        qf = q.reshape(B, cfg.n_kv_heads, g, dh).float()
        s = torch.einsum("bhgd,bshd->bhgs", qf, cache_k.float())
        s = div(s, float(np.sqrt(dh)))
        slots = torch.arange(S_c, device=x.device)
        written = slots <= torch.clamp(pos, max=S_c - 1)
        valid = written if cfg.swa_window else (slots <= pos)
        s = torch.where(valid, s, -1e30)
        pmat = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgs,bshd->bhgd", pmat, cache_v.float())
        o = o.reshape(B, 1, cfg.n_heads * dh).to(x.dtype)
    return x + shard(o @ _w(p["wo"], o.dtype), ("data", None, None))


def decode_step(params: dict, cache: KVCache, token: torch.Tensor,
                cfg: TransformerConfig, shard=no_shard) -> tuple:
    """token: (B,) int → ``(logits (B, vocab) float32, the cache one token
    on)``. The cache's ``k`` and ``v`` are updated in place and returned in
    the new ``KVCache`` beside ``pos + 1``."""
    x = embed(params, token, cfg)[:, None]                   # (B, 1, D)
    x = shard(x, ("data", None, None))
    for i, lp in enumerate(layer_views(params, cfg)):
        x = _decode_attn(lp, x, cache.k[i], cache.v[i], cache.pos, cfg,
                         shard)
        x, _ = _ffn(lp, x, cfg, shard)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ _w(params["lm_head"], x.dtype))[:, 0]
    return logits.float(), KVCache(cache.k, cache.v, cache.pos + 1)


def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int, shard=no_shard) -> tuple:
    """Run the prompt through the model, filling caches; returns the last
    position's float32 logits and the cache.

    Each layer's cache holds its last ``min(S, S_cache)`` keys and values
    (the reference's ``k[:, -s_cache:]``), and ``pos = S``: a ring cache is
    in phase only where ``S % S_cache == 0``, and a full-length cache built
    from ``S < max_len`` tokens has ``S`` slots, as the reference's has
    (ROADMAP Queue 3). The logits take the last position before the vocab
    product (the reference slices after it)."""
    B, S = tokens.shape
    x = embed(params, tokens, cfg)
    x = shard(x, ("data", None, None))
    positions = _positions(B, S, tokens.device)
    shape = _cache_shape(cfg, B, max_len)
    keep = min(S, shape[2])
    shape = shape[:2] + (keep,) + shape[3:]
    cks = torch.empty(shape, dtype=cfg.act_dtype, device=tokens.device)
    cvs = torch.empty(shape, dtype=cfg.act_dtype, device=tokens.device)
    for i, lp in enumerate(layer_views(params, cfg)):
        q, k, v = _qkv(lp, x, positions, cfg, shard)
        cks[i].copy_(k[:, S - keep:])
        cvs[i].copy_(v[:, S - keep:])
        x = _attn_out(lp, x, q, k, v, cfg, shard)
        del q, k, v
        x, _ = _ffn(lp, x, cfg, shard)
    x = rms_norm(x[:, -1:], params["final_norm"])
    logits = (x @ _w(params["lm_head"], x.dtype))[:, 0]
    cache = KVCache(cks, cvs, torch.tensor(S, dtype=torch.int32,
                                           device=tokens.device))
    return logits.float(), cache


# ---------------------------------------------------------------------------
# The module.
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """The model: its float32 parameters in the reference's pytree
    (``params()``, the tensors themselves, which ``legacy.optim`` updates in
    place and ``legacy.checkpoint`` saves in the reference's leaf order),
    and the entry points above as methods."""

    def __init__(self, cfg: TransformerConfig, params: Mapping):
        super().__init__()
        self.cfg = cfg
        leaves, rebuild = flatten(dict(params))
        self._leaves = nn.ParameterList(
            [x if isinstance(x, nn.Parameter) else nn.Parameter(x)
             for x in leaves])
        self._rebuild = rebuild
        want = shape_leaves(param_shapes(cfg))
        got = [tuple(x.shape) for x in self._leaves]
        if got != want:
            raise ValueError(f"{cfg.name}: parameter shapes {got} are not "
                             f"the config's {want}")

    @classmethod
    def from_params(cls, params: Mapping, cfg: TransformerConfig, *,
                    device) -> "Transformer":
        """From the reference's ``init_params`` pytree, as arrays."""
        leaves, rebuild = flatten(dict(params))
        return cls(cfg, rebuild([torch.tensor(np.asarray(x), device=device)
                                 for x in leaves]))

    def params(self) -> dict:
        return self._rebuild(list(self._leaves))

    def forward(self, tokens: torch.Tensor) -> tuple:
        return forward(self.params(), tokens, self.cfg)

    def lm_loss(self, tokens: torch.Tensor, labels: torch.Tensor) -> tuple:
        return lm_loss(self.params(), tokens, labels, self.cfg)

    def prefill(self, tokens: torch.Tensor, max_len: int) -> tuple:
        return prefill(self.params(), tokens, self.cfg, max_len)

    def decode_step(self, cache: KVCache, token: torch.Tensor) -> tuple:
        return decode_step(self.params(), cache, token, self.cfg)


def init_transformer(cfg: TransformerConfig, *, key: torch.Tensor,
                     device=None) -> Transformer:
    """``Transformer`` with ``init_params(key, cfg)``'s weights, drawn on
    ``device`` (the key's own when None)."""
    key = key.to(device) if device is not None else key
    return Transformer(cfg, init_params(key, cfg))
