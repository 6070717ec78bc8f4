"""State-space mixers: Mamba (selective SSM, for Jamba) and RWKV-6 (Finch)
(port of ``repro/models/ssm.py``).

Both are sequential recurrences.  Where the reference runs ``lax.scan``
over time, the port loops over the S positions in Python (a prompt's
prefill is S steps a layer; decode is one); the carried state is O(1) in
the context length.  RWKV prompts that split into more than one whole
``cfg.rwkv_chunk`` take the chunk-parallel path (``_rwkv_chunked``), as in
the reference; the sequential scan stays the decode path and the oracle.
Plain PyTorch throughout: the reference has no Pallas kernel here.

Decode state (one pattern position's layer, batch B):
  mamba: {"conv": (B, d_conv - 1, di), "ssm": (B, di, N)}
  rwkv:  {"wkv": (B, H, hd, hd), "shift_t": (B, d), "shift_c": (B, d)}
The placed serving steps hold a rank's block of them under the specs'
layout (``launch/specs.cache_sharding``): Mamba's channels over ``model``,
RWKV6's state whole on every ``model`` rank, the slots over the batch axes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig
from repro_torch.parallel import fsdp_tp
from repro_torch.parallel import sharding as shd

Tensor = torch.Tensor

DT_RANK_DIV = 16
LORA_DIM = 32


# ===========================================================================
# Mamba (selective SSM)
# ===========================================================================


def mamba_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf shapes of one Mamba mixer."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_d_state
    dt_rank = max(1, d // DT_RANK_DIV)
    return {
        "in_proj": (d, 2 * di),
        "conv_w": (cfg.ssm_d_conv, di),
        "conv_b": (di,),
        "x_proj": (di, dt_rank + 2 * n),
        "dt_proj": (dt_rank, di),
        "dt_bias": (di,),
        "a_log": (di, n),
        "d_skip": (di,),
        "out_proj": (di, d),
    }


def _mamba_conv_full(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Causal depthwise conv over (B, S, di) with kernel (K, di)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def mamba_apply(
    params: Dict[str, Tensor],
    x: Tensor,
    cfg: ArchConfig,
    state: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """x: (B, S, d).  ``state`` given and S == 1: one decode step; else the
    full scan from ``state`` (or zeros), returning the carried state when
    one was given (prefill).

    On placed blocks (``parallel/fsdp_tp``: the 2-D train step, and the
    placed serving steps with ``state``) with ``out_proj`` split over
    ``model`` a rank runs its c = di / m channels: the conv, the scan and
    the skip are per channel; ``in_proj``'s column blocks straddle the
    ``[x | z]`` split, so it is gathered over ``model`` and the rank takes
    its x and z columns; ``x_proj`` is row-parallel and its (dt, B, C)
    output, which feeds every channel, is all-reduced over ``model`` forward
    and backward; ``out_proj`` is row-parallel.  The state is the rank's
    block of the specs' layout (``place_caches``: ``conv`` (B, K - 1, c),
    ``ssm`` (B, c, N), the channels over ``model``), read and returned as
    such; a leaf in another layout is cut or gathered to the channels the
    rank runs and put back (``fsdp_tp.state_block`` / ``state_update``)."""
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    n = cfg.ssm_d_state
    dt_rank = max(1, d // DT_RANK_DIV)
    cd = cfg.compute_dtype
    tp = fsdp_tp.split_over(params["out_proj"], fsdp_tp.MODEL)

    if tp:
        c = di // shd.axis_size(fsdp_tp.MODEL)
        lo = shd.axis_index(fsdp_tp.MODEL) * c
        x = fsdp_tp.enter_tp(x)
        w_in = fsdp_tp.gather(params["in_proj"], model=True, tp=True)
        w_in = torch.cat([w_in[:, lo:lo + c], w_in[:, di + lo:di + lo + c]], dim=1)

        def leaf(name, dim):
            return fsdp_tp.own_slice(params[name], dim)
    else:
        c = di
        w_in = fsdp_tp.gather(params["in_proj"], model=True, repeated=True)

        def leaf(name, dim):
            return fsdp_tp.gather(params[name], model=True, repeated=True)

    xz = x @ w_in.to(cd)
    xin, z = torch.chunk(xz, 2, dim=-1)
    conv_w = leaf("conv_w", 1).to(cd)
    conv_b = leaf("conv_b", 0).to(cd)
    kk = conv_w.shape[0]

    if state is not None:  # the channels this rank runs (dim 2 of conv, 1 of ssm)
        conv0 = fsdp_tp.state_block(state["conv"], 2, tp)
        ssm0 = fsdp_tp.state_block(state["ssm"], 1, tp)
    decode = state is not None and s == 1
    if decode:
        hist = torch.cat([conv0.to(cd), xin], dim=1)  # (B, K, c)
        xc = torch.sum(hist * conv_w[None], dim=1, keepdim=True) + conv_b
        new_conv = hist[:, 1:, :]
    else:
        xc = _mamba_conv_full(xin, conv_w, conv_b)
        new_conv = None
        if state is not None:  # prefill: keep the tail for the decode that follows
            pad = torch.zeros((b, max(0, (kk - 1) - s), c), dtype=cd, device=x.device)
            new_conv = torch.cat([pad, xin[:, -(kk - 1):, :]], dim=1)
    xc = F.silu(xc)

    proj = xc @ leaf("x_proj", 0).to(cd)
    if tp:  # whole (dt, B, C) on every rank; each rank's cotangent is its channels' share
        proj = fsdp_tp.enter_tp(fsdp_tp.exit_tp(proj))
    dt_raw, b_mat, c_mat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = F.softplus(dt_raw @ leaf("dt_proj", 1).to(cd) + leaf("dt_bias", 0).to(cd)).float()  # (B, S, di)
    a = -torch.exp(leaf("a_log", 0).float())  # (di, n)
    da = torch.exp(dt[..., None] * a)  # (B, S, di, n)
    dbx = (dt * xc.float())[..., None] * b_mat.float()[:, :, None, :]
    c32 = c_mat.float()

    h = ssm0.float() if state is not None else torch.zeros((b, c, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        h = da[:, t] * h + dbx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c32[:, t]))
    y = torch.stack(ys, dim=1)  # (B, S, c)

    y = y + xc.float() * leaf("d_skip", 0).float()
    y = y.to(cd) * F.silu(z)
    out = y @ leaf("out_proj", 0).to(cd)
    if tp:
        out = fsdp_tp.exit_tp(out)

    new_state = None
    if state is not None:
        conv = (new_conv if new_conv is not None else conv0).to(cd)
        new_state = {"conv": fsdp_tp.state_update(conv, state["conv"], 2, tp),
                     "ssm": fsdp_tp.state_update(h, state["ssm"], 1, tp)}
    return out, new_state


def mamba_init_state(cfg: ArchConfig, batch: int, device=None, repeats: int = 1) -> Dict[str, Tensor]:
    """Zero Mamba state, (repeats, batch, ...) per leaf."""
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((repeats, batch, cfg.ssm_d_conv - 1, di), dtype=cfg.compute_dtype, device=device),
        "ssm": torch.zeros((repeats, batch, di, cfg.ssm_d_state), dtype=torch.float32, device=device),
    }


# ===========================================================================
# RWKV-6 (Finch): data-dependent decay linear recurrence
# ===========================================================================


def rwkv_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf shapes of one RWKV layer: its time mix and its channel mix."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    return {
        "mu_base": (d,),
        "mu": (5, d),  # r, k, v, w, g
        "lora_a": (d, 5 * LORA_DIM),
        "lora_b": (5, LORA_DIM, d),
        "w_r": (d, d),
        "w_k": (d, d),
        "w_v": (d, d),
        "w_g": (d, d),
        "w_o": (d, d),
        "decay_base": (d,),
        "decay_lora_a": (d, LORA_DIM),
        "decay_lora_b": (LORA_DIM, d),
        "bonus_u": (d // hd, hd),
        "ln_x": (d,),
        "cmix_mu_k": (d,),
        "cmix_mu_r": (d,),
        "cmix_wk": (d, cfg.d_ff),
        "cmix_wv": (cfg.d_ff, d),
        "cmix_wr": (d, d),
    }


def _token_shift(x: Tensor, prev: Optional[Tensor]) -> Tensor:
    """x_{t-1}: shift right by one; position 0 takes ``prev`` (decode carry)."""
    if x.shape[1] == 1:
        return prev[:, None, :] if prev is not None else torch.zeros_like(x)
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1, :]
    if prev is not None:
        shifted = shifted.clone()
        shifted[:, 0, :] = prev
    return shifted


def _wkv_step(wkv: Tensor, r_t: Tensor, k_t: Tensor, v_t: Tensor, w_t: Tensor, u: Tensor):
    """One step of the recurrence: y = r (S + u k v^T); S' = diag(w) S + k v^T."""
    kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, hd, hd)
    y = torch.einsum("bhi,bhij->bhj", r_t, wkv + u[None, :, :, None] * kv)
    return w_t[..., :, None] * wkv + kv, y


def rwkv_time_mix(
    params: Dict[str, Tensor],
    x: Tensor,
    cfg: ArchConfig,
    state: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """The RWKV6 mixer over x: (B, S, d); with ``state`` it starts from the
    carried wkv state and token shift and returns them advanced.

    On placed blocks (``parallel/fsdp_tp``: the 2-D train step, and the
    placed serving steps with ``state``) with ``w_o`` split over ``model`` a
    rank computes the heads of its ``w_o`` rows: ``w_r`` / ``w_k`` /
    ``w_v`` / ``w_g`` are column blocks, and it takes its heads' slices of
    ``decay_base``, ``decay_lora_b``, ``bonus_u`` and ``ln_x`` (the group
    norm and the recurrence need whole heads).  Where d / m is not whole
    heads the four projections are gathered over ``model``, every head is
    computed whole and the rank keeps the columns of its ``w_o`` rows.  The
    ddlerp runs whole on every rank inside the TP region; ``w_o`` is
    row-parallel.  The specs keep ``wkv`` whole on every ``model`` rank
    (``place_caches``): a rank of whole heads a rank reads its heads'
    slice and all-gathers the advanced heads over ``model``
    (``fsdp_tp.state_block`` / ``state_update``, forward only), so that
    every rank holds the same whole leaf; where every head is computed
    whole it reads and writes the whole leaf, with no collective.  The
    token shift reads the whole residual on every rank."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    cd = cfg.compute_dtype
    model = fsdp_tp.MODEL
    tp = fsdp_tp.split_over(params["w_o"], model)
    m = shd.axis_size(model) if tp else 1
    split = tp and h % m == 0 and fsdp_tp.split_over(params["w_r"], model)
    hl = h // m if split else h  # the heads this rank computes
    if tp:
        x = fsdp_tp.enter_tp(x)

    def whole(name):
        return fsdp_tp.gather(params[name], model=True, repeated=not tp, tp=tp)

    def heads(name, dim):  # the leaf's entries of the heads this rank computes
        return fsdp_tp.own_slice(params[name], dim) if split else whole(name)

    prev = state["shift_t"] if state is not None else None
    dx = _token_shift(x, prev) - x

    # data-dependent lerp (ddlerp) through low-rank adapters
    x_base = x + dx * whole("mu_base").to(cd)
    lora = torch.tanh(x_base @ whole("lora_a").to(cd)).reshape(b, s, 5, LORA_DIM)
    adj = torch.einsum("bsfl,fld->bsfd", lora, whole("lora_b").to(cd))  # (B, S, 5, d)
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (whole("mu").to(cd) + adj)
    xr, xk, xv, xw, xg = (mixed[:, :, i, :] for i in range(5))

    r = (xr @ heads("w_r", 1).to(cd)).reshape(b, s, hl, hd)
    k = (xk @ heads("w_k", 1).to(cd)).reshape(b, s, hl, hd)
    v = (xv @ heads("w_v", 1).to(cd)).reshape(b, s, hl, hd)
    g = F.silu(xg @ heads("w_g", 1).to(cd))

    # data-dependent decay w in (0, 1); -log w = exp(dec) feeds the chunked path
    dec = heads("decay_base", 0).float() + (
        torch.tanh(xw @ whole("decay_lora_a").to(cd)) @ heads("decay_lora_b", 1).to(cd)
    ).float()
    neg_logw = torch.exp(dec).reshape(b, s, hl, hd)
    w = torch.exp(-neg_logw)

    u = heads("bonus_u", 0).float()  # (H, hd)
    r32, k32, v32 = r.float(), k.float(), v.float()
    if state is not None:
        wkv = fsdp_tp.state_block(state["wkv"], 1, split).float()
    else:
        wkv = torch.zeros((b, hl, hd, hd), dtype=torch.float32, device=x.device)

    chunk = cfg.rwkv_chunk
    if s == 1 and state is not None:
        wkv, y = _wkv_step(wkv, r32[:, 0], k32[:, 0], v32[:, 0], w[:, 0], u)
        y = y[:, None]
    elif chunk and s % chunk == 0 and s > chunk:
        wkv, y = _rwkv_chunked(r32, k32, v32, -neg_logw, u, wkv, chunk, stream_dtype=cd)
    else:
        ys = []
        for t in range(s):
            wkv, y_t = _wkv_step(wkv, r32[:, t], k32[:, t], v32[:, t], w[:, t], u)
            ys.append(y_t)
        y = torch.stack(ys, dim=1)  # (B, S, H, hd)

    # per-head group norm
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y.reshape(b, s, hl * hd) * heads("ln_x", 0).float()
    y = y.to(cd) * g
    if tp and not split:  # every head whole: the columns of this rank's w_o rows
        cols = d // m
        y = y[..., shd.axis_index(model) * cols:(shd.axis_index(model) + 1) * cols]
    out = y @ (fsdp_tp.own_slice(params["w_o"], 0) if tp else whole("w_o")).to(cd)
    if tp:
        out = fsdp_tp.exit_tp(out)

    new_state = None
    if state is not None:
        new_state = dict(state, wkv=fsdp_tp.state_update(wkv, state["wkv"], 1, split), shift_t=x[:, -1, :])
    return out, new_state


def _rwkv_chunked(r, k, v, logw, u, s0, chunk: int, stream_dtype=torch.float32):
    """Chunk-parallel RWKV-6 (GLA-style).  The recurrence

        S_t = diag(w_t) S_{t-1} + k_t v_t^T ;  y_t = r_t (S_{t-1} + u k_t v_t^T)

    runs per chunk of C tokens as three matmuls, with cum_t the per-channel
    sum of log w up to t:

        y_intra = tril_strict((r e^{cum_{t-1}}) (k e^{-cum_tau})^T) v + (r . u k) v_t
        y_inter = (r e^{cum_{t-1}}) S_chunk_start
        S_next  = e^{cum_C} . S + (k e^{cum_C - cum_tau})^T v

    The exponents take the chunk's mid-point m = cum_C / 2 as reference and
    are clamped at +-60 (a channel that decays past e^-120 inside one chunk
    contributes 0 in f32 anyway).  The streams go in ``stream_dtype`` (the
    compute dtype) and every contraction sums in f32, as the reference's
    ``preferred_element_type`` does; the carried state and the sums stay f32.

    r / k / v / logw: (B, S, H, hd) f32 (logw = log w <= 0); s0: (B, H, hd,
    hd).  Returns (S_final, y (B, S, H, hd))."""
    b, s, h, hd = r.shape
    nc = s // chunk
    sd = stream_dtype

    def resh(t):
        return t.reshape(b, nc, chunk, h, hd)

    def stream(t):  # round to the stream dtype, contract in f32
        return t.to(sd).float()

    rc, kc, vc, lw = resh(r), resh(k), resh(v), resh(logw)
    cum = torch.cumsum(lw, dim=2)  # (B, nc, C, H, hd), <= 0, decreasing in t
    cum_prev = cum - lw  # sum over tau <= t - 1
    cum_end = cum[:, :, -1:, :, :]
    mid = 0.5 * cum_end
    r_dec = stream(rc * torch.exp(torch.clamp(cum_prev - mid, -60.0, 60.0)))
    k_dec = stream(kc * torch.exp(torch.clamp(mid - cum, -60.0, 60.0)))
    r_in = stream(rc * torch.exp(cum_prev))  # <= 1: the inter-chunk query
    k_rem = stream(kc * torch.exp(cum_end - cum))  # <= 1: decay to the chunk's end
    p_end = torch.exp(cum[:, :, -1])  # (B, nc, H, hd) f32
    vc_s = stream(vc)

    # intra-chunk attention-like term (strictly causal) + the diagonal bonus
    a = torch.einsum("bnthi,bnchi->bnhtc", r_dec, k_dec)  # (B, nc, H, C, C)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    a = stream(torch.where(causal, a, torch.zeros((), dtype=a.dtype, device=a.device)))
    y_intra = torch.einsum("bnhtc,bnchj->bnthj", a, vc_s)
    bonus = torch.einsum("bnthi,hi,bnthi->bnth", rc, u, kc)
    y_intra = y_intra + bonus[..., None] * vc

    # inter-chunk: the carried state, one matmul per chunk
    state = s0
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bthi,bhij->bthj", r_in[:, c], stream(state)))
        state = p_end[:, c][..., None] * state + torch.einsum("bthi,bthj->bhij", k_rem[:, c], vc_s[:, c])
    y = y_intra + torch.stack(y_inter, dim=1)
    return state, y.reshape(b, s, h, hd)


def rwkv_channel_mix(
    params: Dict[str, Tensor],
    x: Tensor,
    cfg: ArchConfig,
    state: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """The RWKV channel mix (the layer's FFN), with its own token shift.
    On placed blocks split over ``model`` (the 2-D train step) ``cmix_wk``
    is column-parallel and ``cmix_wv`` row-parallel; the sigmoid gate
    multiplies the whole ``kv``, so every rank computes it whole
    (``cmix_wr`` gathered over ``model``).  ``shift_c``, whole on every
    ``model`` rank in the specs' layout, is the last row of the whole
    residual each rank holds."""
    cd = cfg.compute_dtype
    tp = fsdp_tp.split_over(params["cmix_wv"], fsdp_tp.MODEL)

    def whole(name):
        return fsdp_tp.gather(params[name], model=True, repeated=True)

    prev = state["shift_c"] if state is not None else None
    dx = _token_shift(x, prev) - x
    xk = x + dx * whole("cmix_mu_k").to(cd)
    xr = x + dx * whole("cmix_mu_r").to(cd)
    if tp:
        xk = fsdp_tp.enter_tp(xk)
        wk, wv = fsdp_tp.own_slice(params["cmix_wk"], 1), fsdp_tp.own_slice(params["cmix_wv"], 0)
    else:
        wk, wv = whole("cmix_wk"), whole("cmix_wv")
    k = torch.square(F.relu(xk @ wk.to(cd)))
    kv = k @ wv.to(cd)
    if tp:
        kv = fsdp_tp.exit_tp(kv)
    out = torch.sigmoid(xr @ whole("cmix_wr").to(cd)) * kv
    new_state = None
    if state is not None:
        new_state = dict(state, shift_c=x[:, -1, :])
    return out, new_state


def rwkv_init_state(cfg: ArchConfig, batch: int, device=None, repeats: int = 1) -> Dict[str, Tensor]:
    """Zero RWKV state, (repeats, batch, ...) per leaf."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    cd = cfg.compute_dtype
    return {
        "wkv": torch.zeros((repeats, batch, d // hd, hd, hd), dtype=torch.float32, device=device),
        "shift_t": torch.zeros((repeats, batch, d), dtype=cd, device=device),
        "shift_c": torch.zeros((repeats, batch, d), dtype=cd, device=device),
    }
