"""Mixture-of-Experts FFN with grouped sort-based dispatch (mirrors
``repro.legacy.models.moe``: ``MoEConfig``, ``moe_init``, ``moe_apply``
and the dense oracle ``moe_ref``, on one rank).

Tokens are cut into ``n_groups`` dispatch groups; in each, the top-k
choices are sorted by expert (stable), each expert takes at most ``C``
tokens in that order and the rest are dropped into the dump slot ``E*C``;
the ``(G, E, C, D)`` buffer feeds batched per-expert SwiGLU products, and
each token sums its experts' outputs times their gates. Deterministic and
capacity-bounded as the reference's. On a mesh, ``moe_apply_spmd``
(the reference's explicit-SPMD layer) dispatches on each data shard and
moves the buffer to the experts' ranks in one all_to_all over ``model``
each way, exact or int8 (``spmd.a2a_int8``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ... import random as trandom
from .layers import dense_init, div, no_shard, normal
from .spmd import a2a_int8, all_to_all, extent, reduce_sum, scale_grad


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int
    n_experts: int
    top_k: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    n_groups: int = 1          # dispatch groups (= data shards on the mesh)
    a2a_int8: bool = False     # int8-compress the EP all_to_all (mesh only)

    @property
    def n_experts_padded(self) -> int:
        """Expert tensors are padded to a multiple of 16 (granite's 40 →
        48); phantom experts are never routed to."""
        return -(-self.n_experts // 16) * 16


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    """Tokens an expert takes in a group: ``ceil(cf * Tg * K / E)`` over the
    padded expert count, rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(cfg.capacity_factor * tokens_per_group * cfg.top_k
                      / cfg.n_experts_padded))
    return max(8, -(-c // 8) * 8)


def param_shapes(cfg: MoEConfig) -> dict:
    """The leaves' shapes of ``moe_init``'s pytree."""
    E, D, Fe = cfg.n_experts_padded, cfg.d_model, cfg.d_expert
    out = {"router": (D, cfg.n_experts), "w_gate": (E, D, Fe),
           "w_up": (E, D, Fe), "w_down": (E, Fe, D)}
    if cfg.n_shared:
        Fs = Fe * cfg.n_shared
        out["shared"] = {"w_gate": (D, Fs), "w_up": (D, Fs),
                         "w_down": (Fs, D)}
    return out


def moe_init(key: torch.Tensor, cfg: MoEConfig) -> dict:
    """The reference's ``moe_init(key, cfg)`` (float32), drawn on the key's
    device: the router as ``dense_init``, each expert tensor a normal draw
    divided by ``sqrt(fan_in)``."""
    ks = trandom.split(key, 5)
    E, D, Fe = cfg.n_experts_padded, cfg.d_model, cfg.d_expert
    p = {
        "router": dense_init(D, cfg.n_experts, key=ks[0]),
        "w_gate": div(normal((E, D, Fe), key=ks[1]), math.sqrt(D)),
        "w_up": div(normal((E, D, Fe), key=ks[2]), math.sqrt(D)),
        "w_down": div(normal((E, Fe, D), key=ks[3]), math.sqrt(Fe)),
    }
    if cfg.n_shared:
        Fs = Fe * cfg.n_shared
        sk = trandom.split(ks[4], 3)
        p["shared"] = {
            "w_gate": dense_init(D, Fs, key=sk[0]),
            "w_up": dense_init(D, Fs, key=sk[1]),
            "w_down": dense_init(Fs, D, key=sk[2]),
        }
    return p


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ wg) * (x @ wu)) @ wd``, each weight cast to ``x``'s dtype
    at its use."""
    h = F.silu(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))
    return h @ wd.to(x.dtype)


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, largest
    first, ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x: torch.Tensor, gidx: torch.Tensor, gval: torch.Tensor,
              E: int, C: int) -> tuple:
    """Every group's dispatch at once. x: (G, Tg, D); gidx/gval: (G, Tg, K).
    Returns ``(buf (G, E, C, D), slot, tok, dropped, gates)``, the last four
    (G, Tg*K) in the sorted order."""
    G, Tg, D = x.shape
    K = gidx.shape[-1]
    dev = x.device
    flat_e = gidx.reshape(G, Tg * K)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    fe_sorted = torch.gather(flat_e, 1, order)
    pos = torch.arange(Tg * K, device=dev).expand(G, Tg * K)
    # each expert's first position in the sorted order
    first = torch.full((G, E), Tg * K, dtype=torch.int64, device=dev)
    first.scatter_reduce_(1, fe_sorted, pos, reduce="amin")
    rank = pos - torch.gather(first, 1, fe_sorted)
    dropped = rank >= C
    slot = torch.where(dropped, E * C, fe_sorted * C + rank.clamp(max=C - 1))
    tok = order // K   # flat_t[order]: the token of each sorted entry
    # each entry's row x[tok], gathered from x repeated K times: ``order``
    # is a permutation of the (token, k) pairs, so the gather's backward
    # writes each row once and a token's K gradients add up in the
    # expand's backward, in a fixed order (a gather from x itself would
    # add them with atomics on the card, in no fixed order)
    xk = x[:, :, None].expand(G, Tg, K, D).reshape(G, Tg * K, D)
    rows = torch.gather(xk, 1, order[..., None].expand(G, Tg * K, D))
    buf = x.new_zeros((G, E * C + 1, D))
    # dropped entries all land on the dump row E*C; with several of them
    # the row's value is any one, which is fine only because the row is
    # cut away below
    buf.scatter_(1, slot[..., None].expand(G, Tg * K, D), rows)
    gates = torch.gather(gval.reshape(G, Tg * K), 1, order).to(x.dtype)
    return buf[:, : E * C].reshape(G, E, C, D), slot, tok, dropped, gates


def _combine(ye: torch.Tensor, slot: torch.Tensor, tok: torch.Tensor,
             dropped: torch.Tensor, gates: torch.Tensor, Tg: int,
             K: int) -> torch.Tensor:
    """Each token's sum of its experts' outputs times their gates, added in
    the sorted order as the reference's scatter-add adds them, without
    atomics. ye: (G, E, C, D) → (G, Tg, D)."""
    G, E, C, D = ye.shape
    ye_flat = torch.cat([ye.reshape(G, E * C, D), ye.new_zeros((G, 1, D))],
                        dim=1)
    contrib = torch.gather(ye_flat, 1, slot[..., None].expand(-1, -1, D))
    keep = torch.where(dropped, 0.0, 1.0).to(ye.dtype)
    contrib = contrib * keep[..., None] * gates[..., None]
    # a token's K entries sit at increasing sorted positions; the entry at
    # sorted position p belongs to token tok[p], so the positions of token t
    # are those of a stable sort of tok
    by_tok = torch.sort(tok, dim=-1, stable=True).indices.reshape(G, Tg, K)
    out = ye.new_zeros((G, Tg, D))
    for j in range(K):
        idx = by_tok[:, :, j, None].expand(G, Tg, D)
        out = out + torch.gather(contrib, 1, idx)
    return out


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              shard=no_shard) -> tuple:
    """x: (T, D) tokens → ``(out (T, D), aux_loss)``, the reference's
    ``moe_apply`` on one rank."""
    T, D = x.shape
    E, K, G = cfg.n_experts_padded, cfg.top_k, cfg.n_groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    C = capacity(cfg, Tg)

    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gval, gidx = top_k(probs, K)                             # (T, K)
    gval = gval / torch.clamp(gval.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance aux loss over the unpadded experts
    me = probs.mean(0)
    ce = div(torch.bincount(gidx.reshape(-1), minlength=cfg.n_experts)
             .float(), float(T * K))
    aux = cfg.n_experts * torch.sum(me * ce)

    xg = shard(x.reshape(G, Tg, D), ("data", None, None))
    buf, slot, tok, dropped, gates = _dispatch(
        xg, gidx.reshape(G, Tg, K), gval.reshape(G, Tg, K), E, C)
    dt = x.dtype
    he = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(dt))
    ue = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(dt))
    ye = torch.einsum("gecf,efd->gecd", F.silu(he) * ue,
                      params["w_down"].to(dt))
    out = _combine(ye, slot, tok, dropped, gates, Tg, K).reshape(T, D)
    if cfg.n_shared:
        sp = params["shared"]
        out = out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out, aux


def dropped_share(cfg: MoEConfig, x: torch.Tensor, router: torch.Tensor):
    """``(capacity, share of the T*K choices dropped)`` of one layer's
    dispatch of ``x`` (T, D) through ``router``: what ``moe_apply`` drops."""
    T, _ = x.shape
    G, K = cfg.n_groups, cfg.top_k
    Tg = T // G
    C = capacity(cfg, Tg)
    probs = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
    _, gidx = top_k(probs, K)
    flat = gidx.reshape(G, Tg * K)
    counts = torch.stack([torch.bincount(f, minlength=cfg.n_experts)
                          for f in flat])
    over = torch.clamp(counts - C, min=0).sum()
    return C, float(over) / (T * K)


def moe_ref(params: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Dense oracle: every expert on every token, combined by gate (no
    drops)."""
    T, D = x.shape
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gval, gidx = top_k(probs, cfg.top_k)
    gval = gval / torch.clamp(gval.sum(-1, keepdim=True), min=1e-9)
    ye = torch.stack([swiglu(x, wg, wu, wd) for wg, wu, wd in zip(
        params["w_gate"], params["w_up"], params["w_down"])])  # (E_pad, T, D)
    gate_mat = torch.zeros((T, cfg.n_experts_padded), dtype=torch.float32,
                           device=x.device)
    gate_mat.scatter_(1, gidx, gval)      # top-k ids are distinct a token
    out = torch.einsum("te,etd->td", gate_mat.to(x.dtype), ye)
    if cfg.n_shared:
        sp = params["shared"]
        out = out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out


# ---------------------------------------------------------------------------
# The mesh layer (the reference's ``moe_apply_spmd``).
# ---------------------------------------------------------------------------

def swiglu_mesh(x: torch.Tensor, p: dict, sp: dict, shard) -> torch.Tensor:
    """``swiglu`` on a mesh, ``x`` whole on every model rank: Megatron TP
    (this rank's columns of ``w_gate`` and ``w_up``, its rows of
    ``w_down``, one sum over ``model``) where the specs split them so,
    else with the gathered weights."""
    dt = x.dtype
    if (sp["w_gate"][-1], sp["w_up"][-1], sp["w_down"][-2]) == \
            ("model",) * 3:
        wg, wu, wd = (shard.unfsdp(p[k], sp[k])[0]
                      for k in ("w_gate", "w_up", "w_down"))
        xe = shard.enter(x)
        h = F.silu(xe @ wg.to(dt)) * (xe @ wu.to(dt))
        return shard.reduce_model(h @ wd.to(dt))
    return swiglu(x, *(shard.whole(p[k], sp[k])
                       for k in ("w_gate", "w_up", "w_down")))


def _experts(w: torch.Tensor, spec: tuple, dtype: torch.dtype, shard):
    """This rank's experts ``(E / M, ...)`` whole over the other
    dimensions, in the activation dtype: an FSDP leaf gathered over the
    data axes after the cast, so its gradient is reduce-scattered in that
    dtype, as the reference's. The gradient is scaled by ``1 / M``: every
    model rank of a data shard sends its expert rows the same tokens, so
    the backward adds ``M`` equal copies (the reference divides the
    output's cotangent by the model axis' size instead)."""
    if spec[0] != "model" and shard.M > 1:
        raise ValueError(f"expert weights laid out {spec}: the experts "
                         f"must be split over model")
    w, rest = shard.unfsdp(w, spec, dtype)
    if any(e is not None for e in rest[1:]):
        raise ValueError(f"expert weights laid out {spec}")
    return scale_grad(w, 1.0 / shard.M)


def moe_apply_spmd(params: dict, specs: dict, x: torch.Tensor,
                   cfg: MoEConfig, shard):
    """The reference's ``moe_apply_spmd`` on this rank: ``x`` (T_loc, D)
    is this data shard's tokens, whole on every model rank; ``params``
    this rank's blocks (the experts split over ``model``: EP) and
    ``specs`` their layout. Returns ``(out (T_loc, D), aux)``.

    Dispatch is local to the data shard: the top-k, the stable sort and the
    capacity ``C`` from ``T_loc`` tokens (so a mesh of ``G_d`` data shards
    computes ``moe_apply`` with ``n_groups = G_d``; where the batch is whole
    on every rank, one group). The ``(E, C, D)`` buffer goes as ``M``
    chunks of ``E / M`` experts to their ranks in one all_to_all over
    ``model`` and comes back the same way, exact or int8 on the wire
    (``cfg.a2a_int8``). ``me`` and ``ce`` of the auxiliary loss are summed
    over the data axes. The experts are gathered over the data axes in the
    activation dtype where their spec splits them (FSDP: train cells
    unless ``moe_fsdp`` is off; the reference's ``fsdp_weights`` flag is
    the spec here)."""
    T_loc, D = x.shape
    E, K = cfg.n_experts_padded, cfg.top_k
    mesh, M = shard.mesh, shard.M
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} model ranks")
    E_loc = E // M
    T = T_loc * extent(mesh, shard.bax)
    C = capacity(cfg, T_loc)
    cdt = x.dtype

    router = shard.whole(params["router"], specs["router"])
    logits = (x @ router.to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)
    gval, gidx = top_k(probs, K)
    gval = gval / torch.clamp(gval.sum(-1, keepdim=True), min=1e-9)
    # this shard's load-balance statistics → the global aux by sums
    me = div(reduce_sum(probs.sum(0), mesh, shard.bax), float(T))
    counts = torch.bincount(gidx.reshape(-1),
                            minlength=cfg.n_experts).float()
    ce = div(reduce_sum(counts, mesh, shard.bax), float(T * K))
    aux = cfg.n_experts * torch.sum(me * ce)

    buf, slot, tok, dropped, gates = _dispatch(
        x[None], gidx[None], gval[None], E, C)
    # int8 on the wire only where the reference's explicit layer runs (more
    # than one dispatch group); with one, the reference's ``moe_apply``
    # moves the buffer exactly
    exchange = a2a_int8 if cfg.a2a_int8 and cfg.n_groups > 1 else all_to_all
    # (E, C, D) = (M, E_loc, C, D) → this rank's experts' rows from every
    # model rank: (E_loc, M C, D)
    buf = exchange(buf[0].reshape(M, E_loc, C, D), mesh, "model")
    buf = buf.transpose(0, 1).reshape(E_loc, M * C, D)
    wg, wu, wd = (_experts(params[k], specs[k], cdt, shard)
                  for k in ("w_gate", "w_up", "w_down"))
    he = torch.einsum("ecd,edf->ecf", buf, wg)
    ue = torch.einsum("ecd,edf->ecf", buf, wu)
    ye = torch.einsum("ecf,efd->ecd", F.silu(he) * ue, wd)
    # back to the shard that sent them: (M, E_loc, C, D) = (E, C, D)
    ye = exchange(ye.reshape(E_loc, M, C, D).transpose(0, 1).contiguous(),
                  mesh, "model")
    out = _combine(ye.reshape(1, E, C, D), slot, tok, dropped, gates, T_loc,
                   K).reshape(T_loc, D)
    if cfg.n_shared:
        out = out + swiglu_mesh(x, params["shared"], specs["shared"], shard)
    return out, aux
