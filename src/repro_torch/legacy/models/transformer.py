"""Decoder-only transformer LM (dense + MoE) with GQA, RoPE, SWA and
qk-norm (mirrors ``repro.legacy.models.transformer``: on one rank, and on
a mesh where ``shard`` is a ``spmd.MeshShard`` and the parameters are this
rank's blocks; "The mesh path" below).

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
from torch.utils.checkpoint import checkpoint

from ... import random as trandom
from ..tree import flatten
from .layers import apply_rope, chunked_attention, dense_init, div, no_shard
from .layers import ParamTree, rms_norm
from .moe import MoEConfig, moe_apply, moe_apply_spmd, moe_init
from .moe import param_shapes as moe_shapes
from .moe import swiglu_mesh
from ...core.collectives import shard_index
from .spmd import (
    MeshShard,
    all_to_all,
    gather,
    local_block,
    local_shape,
    spec_axes,
    spec_leaves,
    spec_map,
    tree_paths,
)

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


def _blocker(mesh, specs):
    """``(path, tensor) → this rank's block`` of a leaf of the parameter
    pytree (a copy, so that the whole draw is freed), or the identity."""
    if mesh is None:
        return lambda path, x: x
    by_path = dict(tree_paths(specs))
    return lambda path, x: local_block(x, by_path[path], mesh).clone()


def init_params(key: torch.Tensor, cfg: TransformerConfig, *, mesh=None,
                specs=None) -> dict:
    """The reference's ``init_params(key, cfg)`` (float32), drawn on the
    key's device: layer ``l`` draws from ``split(split(key, 4)[1], L)[l]``
    (the reference's ``vmap`` over the layer keys draws what one call a key
    draws) straight into its slice of each stacked leaf.

    On a ``mesh``, each leaf is this rank's block under ``specs`` (the
    model's spec tree): every leaf is drawn whole, one layer at a time,
    and cut, so a rank holds the one-rank init's values of its block."""
    take = _blocker(mesh, specs)
    k_embed, k_layers, k_head, _ = trandom.split(key, 4)
    layer_keys = trandom.split(k_layers, cfg.n_layers)
    lspecs = spec_leaves(specs["layers"]) if mesh is not None else None
    for i in range(cfg.n_layers):
        leaves, rebuild = flatten(_layer_init(layer_keys[i], cfg))
        if i == 0:
            shapes = [(cfg.n_layers,) + tuple(x.shape) for x in leaves]
            if mesh is not None:
                shapes = [local_shape(sh, sp, mesh)
                          for sh, sp in zip(shapes, lspecs)]
            stacked = [torch.empty(sh, dtype=x.dtype, device=x.device)
                       for sh, x in zip(shapes, leaves)]
            layers = rebuild(stacked)
        for j, (dst, src) in enumerate(zip(stacked, leaves)):
            if mesh is None:
                dst[i].copy_(src)
                continue
            sp = lspecs[j]
            lo, n = 0, dst.shape[0]
            if sp and sp[0] is not None:  # layers split over an axis
                lo = shard_index(mesh, spec_axes(sp[0])) * n
            if lo <= i < lo + n:
                dst[i - lo].copy_(local_block(src, tuple(sp[1:]), mesh))
        del leaves
    embed = take("embed", dense_init(cfg.vocab, cfg.d_model, key=k_embed,
                                     scale=1.0))
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": take("final_norm", torch.ones(
            cfg.d_model, dtype=torch.float32, device=key.device)),
        "lm_head": take("lm_head", dense_init(cfg.d_model, cfg.vocab,
                                              key=k_head)),
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
    if isinstance(shard, MeshShard):
        return _forward_hidden_mesh(params, tokens, cfg, shard)
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
    """tokens (B, S) int → logits (B, S, vocab) + aux loss (on a mesh,
    whole over the vocabulary)."""
    x, aux = forward_hidden(params, tokens, cfg, shard)
    if isinstance(shard, MeshShard):
        return _proj_whole(x, params["lm_head"], shard.specs["lm_head"],
                           shard), aux
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
    if isinstance(shard, MeshShard):
        return _lm_loss_mesh(params, tokens, labels, cfg, shard, aux_weight)
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
    the new ``KVCache`` beside ``pos + 1``. On a mesh the cache is this
    rank's sequence block (``_decode_attn_mesh``)."""
    if isinstance(shard, MeshShard):
        return _decode_step_mesh(params, cache, token, cfg, shard)
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
    product (the reference slices after it). On a mesh: ``_prefill_mesh``."""
    if isinstance(shard, MeshShard):
        return _prefill_mesh(params, tokens, cfg, max_len, shard)
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
# The mesh path: every function above on this rank's blocks (``shard`` a
# ``spmd.MeshShard``; the entry points dispatch on it). Attention and the
# dense FFN are Megatron TP: where the reference's constraint on q
# (``("data", None, "model", None)``: the heads divide the model axis)
# holds, a rank computes its heads of q, k and v from its columns of wq,
# wk and wv and sums ``o @ wo`` over the axis; where the constraint on k
# is dropped (the kv heads do not divide the axis), it gathers wk and wv
# and takes the kv heads its q heads read; where the one on q is dropped,
# it gathers wq, wk, wv and wo and computes every head. The FFN takes its
# columns where ``d_ff`` divides the axis (the reference's ``h12``
# constraint), else the gathered weights. By config, on the production
# 16 x 16 mesh (and 2 x 16 x 16):
#   * qwen3-4b: 32 q heads → 2 a rank; 8 kv heads do not divide 16, so
#     wk/wv (whose columns the fit splits 64 a rank, half a 128-wide head)
#     are gathered and k, v computed whole; the FFN's 9,728 columns split.
#   * h2o-danube-3-4b: 32 q heads → 2; 8 kv heads gathered, as qwen3's.
#   * stablelm-3b: 32 q and kv heads → 2 each: every weight TP.
#   * granite-moe-3b-a800m: 24 heads do not divide 16: wq (split 96
#     columns a rank, mid-head), wk, wv and wo gathered; the vocabulary of
#     49,155 does not divide, so ``embed`` and ``lm_head`` are split over
#     ``d_model`` and gathered at use.
#   * deepseek-moe-16b: 16 heads → 1 a rank (q, k, v, wo TP); the shared
#     experts' 2,816 columns split.
# On the 2 x 2 and 1 x 4 smoke meshes, qwen3's and granite's smoke wk/wv
# split mid-head on 1 x 4 (2 kv heads on 4 ranks): gathered. The MoE is
# ``moe.moe_apply_spmd`` on every mesh. Decode reads a sequence-sharded
# cache: see ``_decode_attn_mesh``.
# ---------------------------------------------------------------------------

def _mesh_layers(params: dict, cfg: TransformerConfig,
                 shard: MeshShard) -> list:
    """``[(layer views, layer specs)]``: the stacked leaves' views, as
    ``layer_views``, beside their specs without the ``L`` entry. A leaf
    whose layers are split over an axis is gathered whole first."""
    leaves, rebuild = flatten(params["layers"])
    specs = spec_leaves(shard.specs["layers"])
    per = []
    for x, sp in zip(leaves, specs):
        if sp and sp[0] is not None:
            axes = spec_axes(sp[0])
            data = all(a in shard.dax for a in axes)
            x = gather(x, shard.mesh, 0, axes,
                       summed=data and shard.batch_split)
        per.append(x.unbind(0))
    tails = spec_map(lambda sp: tuple(sp[1:]), shard.specs["layers"])
    return [(rebuild([p[i] for p in per]), tails)
            for i in range(cfg.n_layers)]


def _embed_mesh(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                shard: MeshShard) -> torch.Tensor:
    """The embeddings, whole on every model rank: vocabulary-parallel
    where ``embed``'s rows are split over ``model`` (each rank looks up the
    tokens in its rows, the rest masked to zero, then one sum), else from
    the gathered table."""
    w, spec = shard.unfsdp(params["embed"], shard.specs["embed"])
    if spec[0] != "model":
        return F.embedding(tokens, shard.whole(w, spec).to(cfg.act_dtype))
    rows = w.shape[0]
    local = tokens.long() - shard.m * rows
    hit = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), w.to(cfg.act_dtype))
    return shard.reduce_model(torch.where(hit[..., None], x, 0))


def _proj_whole(h: torch.Tensor, w: torch.Tensor, spec: tuple,
                shard: MeshShard) -> torch.Tensor:
    """``h @ w`` whole on every model rank, for one token a sequence
    (decode, the logits): from this rank's columns, then gathered; from
    its rows, then summed; or from the gathered weight."""
    w, spec = shard.unfsdp(w, spec)
    w = w.to(h.dtype)
    if spec[-1] == "model":
        return shard.gather_model(shard.enter(h) @ w, h.dim() - 1)
    if len(spec) > 1 and spec[-2] == "model":
        r = w.shape[-2]
        hl = shard.enter(h)[..., shard.m * r: (shard.m + 1) * r]
        return shard.reduce_model(hl @ w)
    return h @ shard.whole(w, spec)


def _kv_for_heads(k: torch.Tensor, cfg: TransformerConfig,
                  shard: MeshShard) -> torch.Tensor:
    """The kv heads (B, S, h, dh) this rank's q heads read, from all of
    them, in ``chunked_attention``'s grouping (local q head ``j`` with kv
    head ``j // (local q heads / h)``)."""
    n = cfg.n_heads // shard.M
    g = cfg.n_heads // cfg.n_kv_heads
    h0 = shard.m * n
    if n % g == 0:
        return k[:, :, h0 // g: (h0 + n) // g]
    if g % n == 0:
        return k[:, :, h0 // g: h0 // g + 1]
    idx = torch.arange(h0, h0 + n, device=k.device) // g
    return k.index_select(2, idx)


def _attn_mesh(p: dict, sp: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: TransformerConfig, shard: MeshShard) -> tuple:
    """``x + attention`` on this rank (Megatron TP as the section says) →
    ``(x, k, v, kv_local)``: k and v after qk-norm and RoPE, of this rank's
    kv heads where ``kv_local``, else of all."""
    B, S, _ = x.shape
    dh, M = cfg.head_dim, shard.M
    h = rms_norm(x, shard.whole(p["ln_attn"], sp["ln_attn"]))
    dt = h.dtype
    q_split = shard.splits(cfg.n_heads)
    k_split = shard.splits(cfg.n_kv_heads)
    he = shard.enter(h) if q_split else h

    def cols(name, heads, split):
        if split:
            w, _ = shard.unfsdp(p[name], sp[name])
            return (he @ _w(w, dt)).reshape(B, S, heads // M, dh)
        w = shard.whole(p[name], sp[name])
        return (h @ _w(w, dt)).reshape(B, S, heads, dh)

    q = cols("wq", cfg.n_heads, q_split)
    k = cols("wk", cfg.n_kv_heads, k_split)
    v = cols("wv", cfg.n_kv_heads, k_split)
    if cfg.qk_norm:
        qn = shard.whole(p["q_norm"], sp["q_norm"])
        kn = shard.whole(p["k_norm"], sp["k_norm"])
        q = rms_norm(q, shard.enter(qn) if q_split else qn)
        k = rms_norm(k, shard.enter(kn) if k_split else kn)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ka, va = k, v
    if q_split and not k_split:
        ka = _kv_for_heads(shard.enter(k), cfg, shard)
        va = _kv_for_heads(shard.enter(v), cfg, shard)
    o = chunked_attention(q, ka, va, causal=True, window=cfg.swa_window,
                          q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
    o = o.reshape(B, S, -1)
    if q_split:
        wo, _ = shard.unfsdp(p["wo"], sp["wo"])
        y = shard.reduce_model(o @ _w(wo, o.dtype))
    else:
        y = o @ _w(shard.whole(p["wo"], sp["wo"]), o.dtype)
    return x + y, k, v, k_split


def _ffn_mesh(p: dict, sp: dict, x: torch.Tensor, cfg: TransformerConfig,
              shard: MeshShard) -> tuple:
    B, S, D = x.shape
    h = rms_norm(x, shard.whole(p["ln_ffn"], sp["ln_ffn"]))
    if cfg.is_moe:
        y, aux = moe_apply_spmd(p["moe"], sp["moe"], h.reshape(B * S, D),
                                cfg.moe_cfg, shard)
        return x + y.reshape(B, S, D), aux
    y = swiglu_mesh(h, p["ffn"], sp["ffn"], shard)
    return x + y, x.new_zeros((), dtype=torch.float32)


def _block_mesh(p, sp, x, positions, cfg, shard) -> tuple:
    x = _attn_mesh(p, sp, x, positions, cfg, shard)[0]
    return _ffn_mesh(p, sp, x, cfg, shard)


def _forward_hidden_mesh(params: dict, tokens: torch.Tensor,
                         cfg: TransformerConfig, shard: MeshShard) -> tuple:
    B, S = tokens.shape
    x = _embed_mesh(params, tokens, cfg, shard)
    positions = _positions(B, S, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for lp, sp in _mesh_layers(params, cfg, shard):
        if cfg.remat:
            x, a = checkpoint(
                lambda x, lp=lp, sp=sp: _block_mesh(lp, sp, x, positions,
                                                    cfg, shard), x,
                use_reentrant=False)
        else:
            x, a = _block_mesh(lp, sp, x, positions, cfg, shard)
        aux = aux + a
    x = rms_norm(x, shard.whole(params["final_norm"],
                                 shard.specs["final_norm"]))
    return x, div(aux, float(cfg.n_layers))


def _xent_mesh(x: torch.Tensor, lm_head: torch.Tensor, spec: tuple,
               labels: torch.Tensor, shard: MeshShard) -> torch.Tensor:
    """``sharded_xent`` on a mesh: vocabulary-parallel where ``lm_head``'s
    columns are split over ``model`` (this rank's logits; the max over the
    axis, then the sums of the exponentials and of the label's logit, each
    one sum over it), else from the gathered head."""
    w, spec = shard.unfsdp(lm_head, spec)
    if spec[-1] != "model":
        return sharded_xent(x, shard.whole(w, spec), labels)
    logits = (shard.enter(x) @ _w(w, x.dtype)).float()
    rows = logits.shape[-1]
    m = shard.pmax_model(torch.amax(logits, dim=-1, keepdim=True))
    lse = torch.log(shard.reduce_model(
        torch.sum(torch.exp(logits - m), dim=-1))) + m[..., 0]
    iota = shard.m * rows + torch.arange(rows, device=logits.device)
    label_logit = shard.reduce_model(torch.sum(
        torch.where(iota == labels[..., None], logits, 0.0), dim=-1))
    return lse - label_logit


def _lm_loss_mesh(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
                  cfg: TransformerConfig, shard: MeshShard,
                  aux_weight: float) -> tuple:
    """The global loss, the same value on every rank; each rank's backward
    differentiates its own tokens' part (the sums pass ``reduce_sum``)."""
    x, aux = _forward_hidden_mesh(params, tokens, cfg, shard)
    nll = _xent_mesh(x, params["lm_head"], shard.specs["lm_head"], labels,
                     shard)
    mask = labels >= 0
    total = shard.reduce_batch(torch.sum(nll * mask))
    count = shard.reduce_batch(mask.sum())
    loss = total / torch.clamp(count, min=1)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


def _heads_to_seq(c: torch.Tensor, shard: MeshShard) -> torch.Tensor:
    """(B, S, h, dh) of this rank's kv heads over every cache slot →
    (B, S / M, h M, dh) of every kv head over its slots: one all_to_all
    over ``model``."""
    B, S, h, dh = c.shape
    M = shard.M
    chunks = c.reshape(B, M, S // M, h, dh).movedim(1, 0)
    got = all_to_all(chunks.contiguous(), shard.mesh, "model")
    return got.movedim(0, 2).reshape(B, S // M, M * h, dh)


def _prefill_mesh(params: dict, tokens: torch.Tensor,
                  cfg: TransformerConfig, max_len: int,
                  shard: MeshShard) -> tuple:
    """``prefill`` on a mesh: the last position's logits whole over the
    vocabulary, and the cache already sequence-sharded for decode (this
    rank's ``keep / M`` slots of every kv head; slot ``j`` of rank ``m`` is
    cache slot ``m keep / M + j``)."""
    B, S = tokens.shape
    M = shard.M
    x = _embed_mesh(params, tokens, cfg, shard)
    positions = _positions(B, S, tokens.device)
    shape = _cache_shape(cfg, B, max_len)
    keep = min(S, shape[2])
    if keep % M:
        raise ValueError(f"a cache of {keep} slots does not split over "
                         f"{M} model ranks")
    per = keep // M
    shape = shape[:2] + (per,) + shape[3:]
    cks = torch.empty(shape, dtype=cfg.act_dtype, device=tokens.device)
    cvs = torch.empty(shape, dtype=cfg.act_dtype, device=tokens.device)
    for i, (lp, sp) in enumerate(_mesh_layers(params, cfg, shard)):
        x, k, v, kv_local = _attn_mesh(lp, sp, x, positions, cfg, shard)
        for dst, c in ((cks, k), (cvs, v)):
            c = c[:, S - keep:]
            if kv_local:
                dst[i].copy_(_heads_to_seq(c, shard))
            else:
                dst[i].copy_(c[:, shard.m * per: (shard.m + 1) * per])
        del k, v
        x, _ = _ffn_mesh(lp, sp, x, cfg, shard)
    x = rms_norm(x[:, -1:], shard.whole(params["final_norm"],
                                         shard.specs["final_norm"]))
    logits = _proj_whole(x, params["lm_head"], shard.specs["lm_head"],
                         shard)[:, 0]
    cache = KVCache(cks, cvs, torch.tensor(S, dtype=torch.int32,
                                           device=tokens.device))
    return logits.float(), cache


def _decode_attn_mesh(p: dict, sp: dict, x: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: torch.Tensor, cfg: TransformerConfig,
                      shard: MeshShard) -> torch.Tensor:
    """``_decode_attn`` against a sequence-sharded cache: this rank holds
    ``S_c / M`` slots of every kv head. q, k and v are whole on every rank
    (from its columns, gathered). Only the rank owning slot ``pos % S_c``
    writes it. Each rank scores its slots; the max over ``model``, then
    the sum of the softmax's denominators, then the sum of the P·V
    products give the reference's softmax over every slot."""
    B = x.shape[0]
    dh, M = cfg.head_dim, shard.M
    per = cache_k.shape[1]
    S_c = per * M
    h = rms_norm(x, shard.whole(p["ln_attn"], sp["ln_attn"]))
    q = _proj_whole(h, p["wq"], sp["wq"], shard).reshape(B, 1, cfg.n_heads,
                                                         dh)
    k = _proj_whole(h, p["wk"], sp["wk"], shard).reshape(
        B, 1, cfg.n_kv_heads, dh)
    v = _proj_whole(h, p["wv"], sp["wv"], shard).reshape(
        B, 1, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(q, shard.whole(p["q_norm"], sp["q_norm"]))
        k = rms_norm(k, shard.whole(p["k_norm"], sp["k_norm"]))
    positions = pos.to(torch.int32).expand(B, 1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    slot = pos.to(torch.int64) % S_c
    at = slot - shard.m * per
    mine = (at >= 0) & (at < per)
    at = at.clamp(0, per - 1).reshape(1)
    for c, new in ((cache_k, k), (cache_v, v)):
        c.index_copy_(1, at, torch.where(mine, new, c.index_select(1, at)))
    with torch.profiler.record_function("lm.attention"):
        g = cfg.n_heads // cfg.n_kv_heads
        qf = q.reshape(B, cfg.n_kv_heads, g, dh).float()
        s = torch.einsum("bhgd,bshd->bhgs", qf, cache_k.float())
        s = div(s, float(np.sqrt(dh)))
        slots = shard.m * per + torch.arange(per, device=x.device)
        written = slots <= torch.clamp(pos, max=S_c - 1)
        valid = written if cfg.swa_window else (slots <= pos)
        s = torch.where(valid, s, -1e30)
        e = torch.exp(s - shard.pmax_model(s.amax(-1, keepdim=True)))
        pmat = e / shard.reduce_model(e.sum(-1, keepdim=True))
        o = shard.reduce_model(
            torch.einsum("bhgs,bshd->bhgd", pmat, cache_v.float()))
        o = o.reshape(B, 1, cfg.n_heads * dh).to(x.dtype)
    return x + _proj_whole(o, p["wo"], sp["wo"], shard)


def _decode_step_mesh(params: dict, cache: KVCache, token: torch.Tensor,
                      cfg: TransformerConfig, shard: MeshShard) -> tuple:
    x = _embed_mesh(params, token, cfg, shard)[:, None]
    for i, (lp, sp) in enumerate(_mesh_layers(params, cfg, shard)):
        x = _decode_attn_mesh(lp, sp, x, cache.k[i], cache.v[i], cache.pos,
                              cfg, shard)
        x, _ = _ffn_mesh(lp, sp, x, cfg, shard)
    x = rms_norm(x, shard.whole(params["final_norm"],
                                 shard.specs["final_norm"]))
    logits = _proj_whole(x, params["lm_head"], shard.specs["lm_head"],
                         shard)[:, 0]
    return logits.float(), KVCache(cache.k, cache.v, cache.pos + 1)


# ---------------------------------------------------------------------------
# The module.
# ---------------------------------------------------------------------------

class Transformer(ParamTree):
    """The model: its float32 parameters in the reference's pytree
    (``params()``, the tensors themselves, which ``legacy.optim`` updates in
    place and ``legacy.checkpoint`` saves in the reference's leaf order),
    and the entry points above as methods.

    On a ``mesh`` (a ``DeviceMesh`` of several ranks) each leaf is this
    rank's block under ``specs`` (``launch.shardings.param_specs``; a
    cell's ``state_shardings[0]``), and the model runs through the cells
    of ``launch.steps``, which take its layout."""

    def __init__(self, cfg: TransformerConfig, params: Mapping, *,
                 mesh=None, specs=None):
        super().__init__(params)
        self.cfg = cfg
        self.mesh = mesh
        self.specs = specs
        want = shape_leaves(param_shapes(cfg))
        if mesh is not None:
            want = [local_shape(w, sp, mesh)
                    for w, sp in zip(want, spec_leaves(specs))]
        got = [tuple(x.shape) for x in self._leaves]
        if got != want:
            raise ValueError(f"{cfg.name}: parameter shapes {got} are not "
                             f"the config's {want}")

    @classmethod
    def from_params(cls, params: Mapping, cfg: TransformerConfig, *,
                    device, mesh=None, specs=None) -> "Transformer":
        """From the reference's ``init_params`` pytree, as arrays (global;
        on a ``mesh``, each rank keeps its block under ``specs``)."""
        if mesh is None:
            return cls(cfg, ParamTree.tensors(params, device=device))
        leaves, rebuild = flatten(dict(params))
        blocks = [local_block(torch.from_numpy(np.asarray(x)), sp, mesh)
                  .to(device=device, copy=True)
                  for x, sp in zip(leaves, spec_leaves(specs))]
        return cls(cfg, rebuild(blocks), mesh=mesh, specs=specs)

    def forward(self, tokens: torch.Tensor) -> tuple:
        return forward(self.params(), tokens, self.cfg)

    def lm_loss(self, tokens: torch.Tensor, labels: torch.Tensor) -> tuple:
        return lm_loss(self.params(), tokens, labels, self.cfg)

    def prefill(self, tokens: torch.Tensor, max_len: int) -> tuple:
        return prefill(self.params(), tokens, self.cfg, max_len)

    def decode_step(self, cache: KVCache, token: torch.Tensor) -> tuple:
        return decode_step(self.params(), cache, token, self.cfg)


def init_transformer(cfg: TransformerConfig, *, key: torch.Tensor,
                     device=None, mesh=None, specs=None) -> Transformer:
    """``Transformer`` with ``init_params(key, cfg)``'s weights, drawn on
    ``device`` (the key's own when None); on a ``mesh``, this rank's
    blocks under ``specs``."""
    key = key.to(device) if device is not None else key
    return Transformer(cfg, init_params(key, cfg, mesh=mesh, specs=specs),
                       mesh=mesh, specs=specs)
