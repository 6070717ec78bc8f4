"""Mixture-of-Experts FFN with GShard-style capacity dispatch (port of
``repro/models/moe.py``).

Each token's router softmax picks ``top_k`` experts (ties to the lower
expert index, as ``jax.lax.top_k`` breaks them); every expert takes at most
``C = max(4, round_up_4(int(T * top_k * capacity_factor / E) + 1))`` token
slots, seated in k-major, then token order — every token's first choice
before any token's second — and the overflow is dropped (its residual passes
through).  The reference builds one-hot dispatch / combine tensors and
contracts them with einsums; here the kept (token, choice) pairs are
scattered into the (E, C, d) expert buffer and gathered back by index, which
seats and weights exactly the same tokens.  The expert products are plain
batched matmuls, as the reference's are plain einsums (no Pallas kernel).

With ``cfg.moe_group_size = G`` the capacity is per G-token group, when the
T tokens split into more than one whole group (``T > G`` and ``T % G == 0``).

Under ``parallel.sharding.data_parallel(axis)`` (the data-parallel LM step)
each rank routes its block of the batch and the batch statistics are the
whole batch's, as GSPMD computes them over the reference's global array:
the router's token and probability fractions are all-reduced over the axis,
and ungrouped dispatch seats every token at its position in the global
(k-major, token) order — an exclusive prefix sum of the ranks' per-expert
claim counts — against the whole batch's capacity.  Grouped dispatch is
rank-local when a rank's block holds whole groups, and raises otherwise.
The batch may be split over a tuple of axes (``("pod", "data")``), its
blocks in row-major order.  On placed blocks whose experts split over
``model`` (the 2-D step) each ``model`` rank runs its E / m experts
(``_moe_groups``).

Variants of the archs: arctic-480b (128 experts top-2 + a dense residual
MLP), llama4-scout (16 experts top-1 + an always-on shared expert), jamba
(16 experts top-2 on every other layer).  ``moe_apply`` returns the
Switch-style load-balance aux loss beside the output.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.decorr.modes import psum_if
from repro_torch.models.common import ArchConfig, activation_fn, mlp_apply
from repro_torch.parallel import fsdp_tp
from repro_torch.parallel import sharding as shd

Tensor = torch.Tensor


def mlp_shapes(cfg: ArchConfig, d_ff: int) -> Dict[str, Tuple[int, ...]]:
    """Leaf shapes of one dense MLP of width ``d_ff``."""
    d = cfg.d_model
    shapes = {"w_in": (d, d_ff), "w_out": (d_ff, d)}
    if cfg.activation in ("swiglu", "geglu"):
        shapes["w_gate"] = (d, d_ff)
    return shapes


def moe_shapes(cfg: ArchConfig) -> Dict[str, object]:
    """Leaf shapes of one MoE FFN: the f32 router, the stacked experts and
    the optional dense residual / shared expert MLPs."""
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    shapes: Dict[str, object] = {"router": (d, e), "w_in": (e, d, ff), "w_out": (e, ff, d)}
    if cfg.activation in ("swiglu", "geglu"):
        shapes["w_gate"] = (e, d, ff)
    if cfg.dense_residual:
        shapes["dense"] = mlp_shapes(cfg, cfg.d_ff)
    if cfg.shared_expert:
        shapes["shared"] = mlp_shapes(cfg, ff)
    return shapes


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, -(-c // 4) * 4)


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest along the last axis, equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _global_offsets(mask: Tensor, axis) -> Tensor:
    """(k, E) offsets that move this rank's (k-major, token) claim
    positions to the whole batch's order, the ranks' blocks in row-major
    order over ``axis`` (a mesh axis or a tuple of them, the first major, as
    the batch's blocks are laid out): claims of earlier choices on every
    rank, then of the same choice on earlier ranks.  ``mask``: (1, G, k, E)
    one-hot claims of this rank."""
    counts = mask[0].sum(dim=0)  # (k, E)
    every = counts[None]
    for group in reversed(shd.axis_groups(axis)):  # the minor axis first: row-major blocks
        every = fsdp_tp.gather_dim(every, 0, group)  # (ranks, k, E)
    r = shd.axis_index(axis)
    before = lambda c: torch.cumsum(c, dim=0) - c  # noqa: E731  (exclusive, over choices)
    return before(every.sum(dim=0)) - before(counts) + every[:r].sum(dim=0)


def _moe_groups(params: Dict[str, Tensor], xg: Tensor, cfg: ArchConfig, axis=None,
                span: bool = False) -> Tuple[Tensor, Tensor]:
    """xg: (n, G, d) -> ((n, G, d), aux): route, seat and run each group's
    tokens with a per-group capacity (one group: the reference's
    ``_moe_one_group``; more: its ``_moe_grouped``).  ``axis``: the
    data-parallel axis, over which the aux loss's fractions are taken;
    ``span``: the one group spans every rank's block (global positions and
    the whole batch's capacity).

    With the experts split over ``model`` (placed blocks, the 2-D step)
    every ``model`` rank routes the same tokens the same way, seats only
    the claims of its own E / m experts (the others go to the spare slot)
    and combines them into a partial output, all-reduced over ``model``.
    The dispatched rows and the gate values enter the TP region (their
    cotangents are this rank's share); the router's softmax also feeds the
    load-balance aux, which every rank computes whole, so the router's
    input and weight do not."""
    n, g, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    ranks = shd.axis_size(axis) if axis is not None else 1
    cap = _capacity(g * ranks if span else g, cfg)
    cd = cfg.compute_dtype
    ep = fsdp_tp.split_dim(params["w_in"], fsdp_tp.MODEL) == 0
    el = params["w_in"].shape[0] if ep else e  # the experts this rank computes
    lo = shd.axis_index(fsdp_tp.MODEL) * el if ep else 0

    router = fsdp_tp.gather(params["router"], model=True, repeated=True)
    logits = xg.float() @ router.float()  # (n, G, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # (n, G, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # position in expert: the count of earlier claims in (k-major, token) order
    mask = F.one_hot(expert_idx, e)  # (n, G, k, E)
    mask_flat = mask.transpose(1, 2).reshape(n, k * g, e)
    pos_flat = torch.cumsum(mask_flat, dim=1) - mask_flat
    pos = (pos_flat.reshape(n, k, g, e).transpose(1, 2) * mask).sum(dim=-1)  # (n, G, k)
    if span and ranks > 1:
        off = _global_offsets(mask, axis)  # (k, E)
        pos = pos + off[torch.arange(k, device=xg.device), expert_idx]
    keep = pos < cap
    if ep:
        keep = keep & (expert_idx >= lo) & (expert_idx < lo + el)
        local = (expert_idx - lo).clamp(0, el - 1)
        xg, gate_vals = fsdp_tp.enter_tp(xg), fsdp_tp.enter_tp(gate_vals)
    else:
        local = expert_idx

    # dispatch: kept (group, token, choice) -> expert buffer (E, n, C, d).  A
    # dropped claim (and, split over "model", another rank's) lands in a
    # spare slot C that is cut off: the shapes never depend on the routing
    # (no host sync, and a fake-tensor analysis runs it)
    grp = torch.arange(n, device=xg.device)[:, None, None].expand(n, g, k)
    tok = torch.arange(g, device=xg.device)[None, :, None].expand(n, g, k)
    slot = torch.where(keep, pos, cap)
    xe = xg.new_zeros((el, n, cap + 1, d))
    xe[local, grp, slot] = xg[grp, tok]
    xe = xe[:, :, :cap].reshape(el, n * cap, d)
    act = activation_fn(cfg.activation)

    def w(name):
        return fsdp_tp.gather(params[name], model=not ep, repeated=True).to(cd)

    h = torch.bmm(xe, w("w_in"))
    if "w_gate" in params:
        h = act(torch.bmm(xe, w("w_gate"))) * h
    else:
        h = act(h)
    ye = torch.bmm(h, w("w_out")).reshape(el, n, cap, d)

    # combine: each token's kept choices, weighted by their gate values
    weight = (gate_vals * keep).to(xg.dtype)
    picked = ye[local, grp, pos.clamp(max=cap - 1)]  # (n, G, k, d)
    out = (weight[..., None] * picked).sum(dim=2)
    if ep:
        out = fsdp_tp.exit_tp(out)

    tokens = float(n * g * ranks)
    frac_tokens = psum_if(mask[:, :, 0].float().sum(dim=(0, 1)), axis) / tokens  # top-1 share per expert
    frac_probs = psum_if(probs.sum(dim=(0, 1)), axis) / tokens
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out, aux


def moe_apply(params: Dict[str, Tensor], x: Tensor, cfg: ArchConfig) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss).  The B * S tokens route
    together (row-major), padding and idle lanes included, as the
    reference's do."""
    b, s, d = x.shape
    t = b * s
    g = cfg.moe_group_size
    axis = shd.data_parallel_axis()
    t_all = t * (shd.axis_size(axis) if axis is not None else 1)
    if g and t_all > g and t_all % g == 0:
        if t % g:
            raise ValueError(
                f"{cfg.name}: grouped MoE dispatch under data parallelism needs each rank's block to hold "
                f"whole groups: {t} tokens a rank is not a multiple of moe_group_size={g}")
        out, aux = _moe_groups(params, x.reshape(t // g, g, d), cfg, axis)
    else:
        out, aux = _moe_groups(params, x.reshape(1, t, d), cfg, axis, span=True)
    out = out.reshape(b, s, d)
    if cfg.dense_residual and "dense" in params:
        out = out + mlp_apply(params["dense"], x, cfg)
    if cfg.shared_expert and "shared" in params:
        out = out + mlp_apply(params["shared"], x, cfg)
    return out.to(x.dtype), aux
