"""Mixture-of-Experts: top-k routing with capacity-bounded gather dispatch.

The reference's design (``repro.models.moe``), on one device:

* router logits -> top-k experts per token, probs renormalised over the k;
* position_in_expert via a cumulative sum per (batch-row, expert) with a
  capacity bound C = ceil(S * k / E * capacity_factor): overflow tokens drop
  (their combine weight is zero);
* dispatch: int32 slot indices scattered into an (b, E * C) table, tokens
  gathered into an (b, E, C, d) buffer;
* expert compute: one einsum over stacked expert weights (E, d, ff);
* combine: gather back with the routing probs as weights.

Shared experts (DeepSeekMoE) are a plain dense SwiGLU over all tokens, added
to the routed output.

``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk`` does
not promise an order, so the top k come from a stable descending sort.

Under tensor parallelism (``parallel.tp``) the router's expert columns and
the experts are the rank's: the (b, s, E) router logits are assembled
before the softmax and the top-k (so ties resolve exactly as on one
device), each rank fills and computes its experts' slots of the dispatch
buffer, and the combine -- with the shared experts' row-parallel term --
is one psum over ``model``.  Tokens are replicated along ``model``, so no
all-to-all moves them.  Capacity and the dropped tokens are the
reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel import act_sharding, tp
from repro_torch.parallel.act_sharding import constrain_ec, constrain_tokens


def moe_init(gen, cfg, dtype=torch.float32, lead=(), device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = layers.on(gen, device)
    p = {
        "router": layers.dense_init(gen, (d, e), d, torch.float32, lead, dev),
        "wi_gate": layers.dense_init(gen, (e, d, f), d, dtype, lead, dev),
        "wi_up": layers.dense_init(gen, (e, d, f), d, dtype, lead, dev),
        "wo": layers.dense_init(gen, (e, f, d), f, dtype, lead, dev),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(gen, d, cfg.n_shared_experts * f,
                                      dtype, lead, dev)
    return p


def expert_capacity(cfg, seq_len: int) -> int:
    c = int(seq_len * cfg.n_experts_per_token * cfg.moe_capacity_factor
            / cfg.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def top_k(probs, k):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_layer(params, x, cfg, compute_dtype):
    """x: (b, s, d) -> (b, s, d)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    cap = expert_capacity(cfg, s)
    dev = x.device
    ax = act_sharding.model_axis()
    # experts on 'model': the rank's experts [lo, hi), slots lo * C on
    ex = act_sharding.tp_axis(params["wi_gate"], 0)
    lo = tp.offset(params["wi_gate"].shape[0], ex)
    hi = lo + params["wi_gate"].shape[0]
    xl = tp.copy(x, ax)        # x entering the local compute (one psum back)
    local = lambda on: xl if on is not None else x

    router = params["router"]
    r_ax = act_sharding.tp_axis(router, 1)
    logits = tp.assemble(local(r_ax).float() @ router, r_ax, -1)
    probs = torch.softmax(logits, dim=-1)                      # (b, s, E)
    top_p, top_e = top_k(probs, k)                             # (b, s, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # position_in_expert: sequential cumsum over the k choices then tokens
    onehot = F.one_hot(top_e, e).to(torch.int32)               # (b, s, k, E)
    flat = onehot.reshape(b, s * k, e)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1     # (b, s*k, E)
    pos = (pos * flat).sum(-1, dtype=torch.int32).reshape(b, s, k)
    keep = (pos < cap) & (top_p > 0.0)
    pos_c = torch.clamp(pos, max=cap - 1)

    # dispatch: scatter int32 slot indices, then gather the tokens
    slot = top_e.to(torch.int32) * cap + pos_c                 # (b, s, k)
    slot = torch.where(keep, slot, e * cap).long()             # drop bucket
    src_of_slot = torch.full((b, e * cap + 1), s * k, dtype=torch.long,
                             device=dev)
    flat_tok = torch.arange(s * k, device=dev).expand(b, s * k)
    # kept slots are distinct; dropped ones all land in the discarded bucket
    src_of_slot.scatter_(1, slot.reshape(b, s * k), flat_tok)
    src_of_slot = src_of_slot[:, lo * cap:hi * cap]            # (b, E*C)

    x_flat = torch.repeat_interleave(local(ex).to(compute_dtype), k, dim=1)
    x_flat = torch.cat([x_flat, x_flat.new_zeros(b, 1, d)], dim=1)
    xe = torch.gather(x_flat, 1, src_of_slot[..., None].expand(-1, -1, d))
    xe = constrain_ec(xe)                       # the reference's a2a
    xe = xe.reshape(b, hi - lo, cap, d)

    # expert FFN (SwiGLU) over stacked weights
    h = F.silu(torch.einsum("becd,edf->becf", xe,
                            params["wi_gate"].to(compute_dtype)))
    h = h * torch.einsum("becd,edf->becf", xe,
                         params["wi_up"].to(compute_dtype))
    ye = torch.einsum("becf,efd->becd", h, params["wo"].to(compute_dtype))

    # combine: gather each token's k outputs (the rank's slots; the
    # others' read a zero row)
    ye = constrain_tokens(ye.reshape(b, (hi - lo) * cap, d))
    ye = torch.cat([ye, ye.new_zeros(b, 1, d)], dim=1)
    slot_flat = slot.reshape(b, s * k) - lo * cap
    slot_flat = torch.where((slot_flat >= 0) & (slot_flat < (hi - lo) * cap),
                            slot_flat, (hi - lo) * cap)
    yk = torch.gather(ye, 1, slot_flat[..., None].expand(-1, -1, d))
    yk = yk.reshape(b, s, k, d)
    wk = torch.where(keep, top_p, 0.0).to(compute_dtype)
    y = (yk * tp.copy(wk, ex)[..., None]).sum(dim=2)

    if "shared" in params:
        sh = params["shared"]
        s_ax = act_sharding.tp_axis(sh["wi_gate"], 1)
        ys = layers.mlp_partial(sh, local(s_ax), compute_dtype)
        if s_ax is not None and ex is not None:
            return tp.psum(y + ys, ax)                # one combine psum
        return tp.psum(y, ex) + tp.psum(ys, s_ax)
    return tp.psum(y, ex)


def load_balancing_loss(router_logits, top_e, n_experts):
    """Switch-style aux loss: mean_frac_tokens * mean_router_prob per expert."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    density = F.one_hot(top_e[..., 0].long(), n_experts).float().mean(
        dim=(0, 1))
    router_mean = probs.mean(dim=(0, 1))
    return n_experts * torch.sum(density * router_mean)
