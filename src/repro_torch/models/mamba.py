"""Selective state-space layers: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2).

Prefill runs a *chunked* scan, as the reference (``repro.models.mamba``)
does: a loop over sequence chunks carrying the (b, ..., state) SSM state.
Inside a chunk the reference runs an associative scan of
h_t = a_t * h_{t-1} + b_t; here the same recurrence runs step by step,
carried across chunks.  The two sum in different orders, so they agree to
float32 rounding, not bit for bit.  Zamba2's ``ssm_impl="ssd"`` is the
matmul dual form (:func:`_mamba2_ssd_chunks`), mirrored op for op.

Decode is a single O(1) state update: one new token against the carried
state and the last ``ssm_conv - 1`` conv inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def _chunk_split(x, n_chunks, Q):
    """(B, S, ...) -> (n_chunks, B, Q, ...) with zero right-padding."""
    B, S = x.shape[0], x.shape[1]
    pad = n_chunks * Q - S
    if pad:
        x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
    return torch.movedim(x.reshape((B, n_chunks, Q) + x.shape[2:]), 1, 0)


def _ssm_scan_chunks(make_chunk, outputs_of, S, Q, h0, xs_chunks):
    """Scan over sequence chunks carrying the SSM state.

    ``make_chunk(chunk_inputs) -> (a_q, b_q)`` builds the state-expanded
    decay/input tensors for ONE chunk only, and ``outputs_of(h, chunk_inputs)
    -> y_q`` contracts the state back to activations, so the (B, Q, d, n)
    expansion exists for one chunk at a time.
    """
    h_prev, ys = h0, []
    for c in range(xs_chunks[0].shape[0]):
        ci = tuple(x[c] for x in xs_chunks)
        a_q, b_q = make_chunk(ci)                 # (B, Q, ...) expanded
        a_q = a_q.expand_as(b_q)
        hs = []                   # stacked, not written in place: autograd
        for t in range(b_q.shape[1]):
            h_prev = a_q[:, t] * h_prev + b_q[:, t]
            hs.append(h_prev)
        ys.append(outputs_of(torch.stack(hs, dim=1), ci))
    y = torch.stack(ys, dim=1)                    # (B, n_chunks, Q, ...)
    y = y.reshape((y.shape[0], -1) + y.shape[3:])
    return y[:, :S], h_prev


def _causal_conv(x, w, bias):
    """Depthwise causal conv: x (b, s, d), w (d, k) -> (b, s, d)."""
    k = w.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xi * w[None, None, :, i]
    return out + bias[None, None, :]


def _conv_in(params, x_in, conv0, compute_dtype):
    """The conv over the new inputs, after the carried ``conv0`` if any."""
    w = params["conv_w"].to(compute_dtype)
    b = params["conv_b"].to(compute_dtype)
    if conv0 is None:
        return _causal_conv(x_in, w, b)
    x_cat = torch.cat([conv0.to(compute_dtype), x_in], dim=1)
    return _causal_conv(x_cat, w, b)[:, conv0.shape[1]:]


def _conv_state(x_in, conv0, k, compute_dtype):
    """The last k - 1 conv inputs (zero-padded on the left)."""
    if conv0 is not None:
        state = torch.cat([conv0, x_in], dim=1)[:, -(k - 1):]
    else:
        s = x_in.shape[1]
        state = F.pad(x_in, (0, 0, k - 1 - min(s, k - 1), 0))[:, -(k - 1):]
    return state.to(compute_dtype)


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------
def mamba1_init(gen, cfg, dtype=torch.float32, lead=(), device=None):
    d, din, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    dev, lead = layers.on(gen, device), tuple(lead)
    dense = lambda shape, fan, dt=dtype: layers.dense_init(gen, shape, fan, dt,
                                                           lead, dev)
    u = torch.empty(lead + (din,), dtype=torch.float32, device=dev)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    dt_bias = torch.log(torch.expm1(torch.exp(u)))
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev)).expand(lead + (din, n))
    return {
        "in_proj": dense((d, 2 * din), d),
        "conv_w": layers.normal(gen, (din, cfg.ssm_conv), 0.1, dtype, lead,
                                dev),
        "conv_b": torch.zeros(lead + (din,), dtype=dtype, device=dev),
        "x_proj": dense((din, r + 2 * n), din),
        "dt_proj": dense((r, din), r, torch.float32),
        "dt_bias": dt_bias,
        "A_log": a_log.contiguous(),
        "D": torch.ones(lead + (din,), dtype=torch.float32, device=dev),
        "out_proj": dense((din, d), din),
    }


def mamba1_forward(params, x, cfg, compute_dtype, h0=None, conv0=None,
                   return_state: bool = False):
    """x: (b, s, d).  h0: (b, din, n) initial state; conv0: (b, k-1, din)."""
    b, s, d = x.shape
    din, n, r = cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    xz = x @ params["in_proj"].to(compute_dtype)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_c = F.silu(_conv_in(params, x_in, conv0, compute_dtype))

    proj = x_c @ params["x_proj"].to(compute_dtype)
    dt_raw = proj[..., :r].float()
    Bm = proj[..., r:r + n].float()                     # (b, s, n)
    Cm = proj[..., r + n:].float()
    dt = F.softplus(dt_raw @ params["dt_proj"] + params["dt_bias"])
    A = -torch.exp(params["A_log"])                     # (din, n)

    if h0 is None:
        h0 = torch.zeros((b, din, n), dtype=torch.float32, device=x.device)
    Q = min(cfg.ssm_chunk, s)
    n_chunks = -(-s // Q)
    xs = (_chunk_split(dt, n_chunks, Q),
          _chunk_split(Bm, n_chunks, Q),
          _chunk_split(Cm, n_chunks, Q),
          _chunk_split(x_c.float(), n_chunks, Q))

    def make_chunk(ci):
        dt_q, B_q, _, x_q = ci
        da = torch.exp(dt_q[..., None] * A[None, None])   # (b, Q, din, n)
        dbx = (dt_q * x_q)[..., None] * B_q[:, :, None, :]
        return da, dbx

    def outputs_of(h, ci):
        _, _, C_q, x_q = ci
        return torch.einsum("bqdn,bqn->bqd", h, C_q) + params["D"] * x_q

    y, h_last = _ssm_scan_chunks(make_chunk, outputs_of, s, Q, h0, xs)
    y = y.to(compute_dtype) * F.silu(z)
    out = y @ params["out_proj"].to(compute_dtype)
    if return_state:
        return out, h_last, _conv_state(x_in, conv0, cfg.ssm_conv,
                                        compute_dtype)
    return out


def mamba1_decode(params, x, cfg, compute_dtype, h, conv_state):
    """One-token step.  x: (b, 1, d); h: (b, din, n); conv: (b, k-1, din)."""
    return mamba1_forward(params, x, cfg, compute_dtype, h0=h,
                          conv0=conv_state, return_state=True)


# ---------------------------------------------------------------------------
# Mamba-2 (scalar-per-head decay; SSD recurrence form)
# ---------------------------------------------------------------------------
def mamba2_init(gen, cfg, dtype=torch.float32, lead=(), device=None):
    d, din, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.ssm_heads
    dev, lead = layers.on(gen, device), tuple(lead)
    dense = lambda shape, fan, dt=dtype: layers.dense_init(gen, shape, fan, dt,
                                                           lead, dev)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=dev)).expand(lead + (H,))
    return {
        "in_proj": dense((d, 2 * din), d),
        "conv_w": layers.normal(gen, (din, cfg.ssm_conv), 0.1, dtype, lead,
                                dev),
        "conv_b": torch.zeros(lead + (din,), dtype=dtype, device=dev),
        "B_proj": dense((d, n), d),
        "C_proj": dense((d, n), d),
        "dt_proj": dense((d, H), d, torch.float32),
        "dt_bias": torch.zeros(lead + (H,), dtype=torch.float32, device=dev),
        "A_log": a_log.contiguous(),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "out_proj": dense((din, d), din),
    }


def mamba2_forward(params, x, cfg, compute_dtype, h0=None, conv0=None,
                   return_state: bool = False):
    """x: (b, s, d).  State h: (b, H, P, n)."""
    b, s, d = x.shape
    din, n = cfg.d_inner, cfg.ssm_state
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    xz = x @ params["in_proj"].to(compute_dtype)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_c = F.silu(_conv_in(params, x_in, conv0, compute_dtype))

    Bm = (x @ params["B_proj"].to(compute_dtype)).float()
    Cm = (x @ params["C_proj"].to(compute_dtype)).float()
    dt = F.softplus(x.float() @ params["dt_proj"] + params["dt_bias"])
    A = -torch.exp(params["A_log"])                     # (H,)

    xh = x_c.float().reshape(b, s, H, Pd)
    if h0 is None:
        h0 = torch.zeros((b, H, Pd, n), dtype=torch.float32, device=x.device)
    Q = min(cfg.ssm_chunk, s)
    if cfg.ssm_impl == "ssd" and s > 1:
        y, h_last = _mamba2_ssd_chunks(dt, Bm, Cm, xh, A, h0, Q, s,
                                       params["D"])
    else:
        n_chunks = -(-s // Q)
        xs = (_chunk_split(dt, n_chunks, Q),
              _chunk_split(Bm, n_chunks, Q),
              _chunk_split(Cm, n_chunks, Q),
              _chunk_split(xh, n_chunks, Q))

        def make_chunk(ci):
            dt_q, B_q, _, x_q = ci
            a_q = torch.exp(dt_q * A[None, None, :])      # (b, Q, H)
            dbx = (dt_q[..., None] * x_q)[..., None] \
                * B_q[:, :, None, None, :]
            return a_q[..., None, None], dbx            # (b, Q, H, P, n)

        def outputs_of(hh, ci):
            _, _, C_q, x_q = ci
            return (torch.einsum("bqhpn,bqn->bqhp", hh, C_q)
                    + params["D"][None, None, :, None] * x_q)

        y, h_last = _ssm_scan_chunks(make_chunk, outputs_of, s, Q, h0, xs)
    y = y.reshape(b, s, din).to(compute_dtype) * F.silu(z)
    out = y @ params["out_proj"].to(compute_dtype)
    if return_state:
        return out, h_last, _conv_state(x_in, conv0, cfg.ssm_conv,
                                        compute_dtype)
    return out


def _mamba2_ssd_chunks(dt, Bm, Cm, xh, A, h0, Q, S, D_skip):
    """Mamba-2 SSD dual form: chunked matmul processing.

    Within a chunk the recurrence unrolls to
        y[t] = C_t . h_prev * alpha_t                       (inter-chunk)
              + sum_{s<=t} (alpha_t/alpha_s) dt_s (C_t.B_s) x_s   (intra)
    with alpha the within-chunk cumulative decay -- the intra term is two
    (Q x Q) matmuls per head.  Ratios alpha_t/alpha_s are <= 1 (decay), so
    the masked-decay matrix is numerically safe.

    Shapes: dt (b,S,H), Bm/Cm (b,S,n), xh (b,S,H,P), h0 (b,H,P,n).
    Returns (y (b,S,H,P), h_last).
    """
    b, _, H = dt.shape
    n_chunks = -(-S // Q)
    xs = (_chunk_split(dt, n_chunks, Q), _chunk_split(Bm, n_chunks, Q),
          _chunk_split(Cm, n_chunks, Q), _chunk_split(xh, n_chunks, Q))
    h_prev, ys = h0, []
    for c in range(n_chunks):
        dt_q, B_q, C_q, x_q = (x[c] for x in xs)    # (b,Q,H) (b,Q,n) ...
        loga = dt_q * A[None, None, :]                # log decay, <= 0
        cum = torch.cumsum(loga, dim=1)               # (b, Q, H)
        alpha = torch.exp(cum)
        # intra-chunk: scores shared across heads, decay per head
        scores = torch.einsum("btn,bsn->bts", C_q, B_q)     # (b, Q, Q)
        t_idx = torch.arange(dt_q.shape[1], device=dt.device)
        causal = (t_idx[:, None] >= t_idx[None, :])[None, :, :, None]
        diff = torch.where(causal, cum[:, :, None, :] - cum[:, None, :, :],
                           -torch.inf)
        M = scores[:, :, :, None] * torch.exp(diff) \
            * dt_q[:, None, :, :]                           # (b,t,s,H)
        y = torch.einsum("btsh,bshp->bthp", M, x_q)
        # inter-chunk contribution
        y = y + alpha[..., None] * torch.einsum("btn,bhpn->bthp", C_q, h_prev)
        # state update: h_new = alpha_Q h_prev + sum_s (alpha_Q/alpha_s) ...
        aQ = alpha[:, -1]                                    # (b, H)
        w = torch.exp(cum[:, -1:, :] - cum) * dt_q           # (b, Q, H)
        h_prev = (aQ[:, :, None, None] * h_prev
                  + torch.einsum("bshp,bsn->bhpn", x_q * w[..., None], B_q))
        ys.append(y + D_skip[None, None, :, None] * x_q)
    y = torch.stack(ys, dim=1)
    y = y.reshape((b, n_chunks * Q) + y.shape[3:])
    return y[:, :S], h_prev


def mamba2_decode(params, x, cfg, compute_dtype, h, conv_state):
    return mamba2_forward(params, x, cfg, compute_dtype, h0=h,
                          conv0=conv_state, return_state=True)
