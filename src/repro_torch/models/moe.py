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

Variants of the archs: arctic-480b (128 experts top-2 + a dense residual
MLP), llama4-scout (16 experts top-1 + an always-on shared expert), jamba
(16 experts top-2 on every other layer).  ``moe_apply`` returns the
Switch-style load-balance aux loss beside the output.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, activation_fn, mlp_apply

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


def _moe_groups(params: Dict[str, Tensor], xg: Tensor, cfg: ArchConfig) -> Tuple[Tensor, Tensor]:
    """xg: (n, G, d) -> ((n, G, d), aux): route, seat and run each group's
    tokens with a per-group capacity (one group: the reference's
    ``_moe_one_group``; more: its ``_moe_grouped``)."""
    n, g, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(g, cfg)
    cd = cfg.compute_dtype

    logits = xg.float() @ params["router"].float()  # (n, G, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # (n, G, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # position in expert: the count of earlier claims in (k-major, token) order
    mask = F.one_hot(expert_idx, e)  # (n, G, k, E)
    mask_flat = mask.transpose(1, 2).reshape(n, k * g, e)
    pos_flat = torch.cumsum(mask_flat, dim=1) - mask_flat
    pos = (pos_flat.reshape(n, k, g, e).transpose(1, 2) * mask).sum(dim=-1)  # (n, G, k)
    keep = pos < cap

    # dispatch: kept (group, token, choice) -> expert buffer (E, n, C, d)
    grp = torch.arange(n, device=xg.device)[:, None, None].expand(n, g, k)
    tok = torch.arange(g, device=xg.device)[None, :, None].expand(n, g, k)
    xe = xg.new_zeros((e, n, cap, d))
    xe[expert_idx[keep], grp[keep], pos[keep]] = xg[grp[keep], tok[keep]]
    xe = xe.reshape(e, n * cap, d)
    act = activation_fn(cfg.activation)
    h = torch.bmm(xe, params["w_in"].to(cd))
    if "w_gate" in params:
        h = act(torch.bmm(xe, params["w_gate"].to(cd))) * h
    else:
        h = act(h)
    ye = torch.bmm(h, params["w_out"].to(cd)).reshape(e, n, cap, d)

    # combine: each token's kept choices, weighted by their gate values
    weight = (gate_vals * keep).to(xg.dtype)
    picked = ye[expert_idx, grp, pos.clamp(max=cap - 1)]  # (n, G, k, d)
    out = (weight[..., None] * picked).sum(dim=2)

    frac_tokens = mask[:, :, 0].float().mean(dim=(0, 1))  # top-1 share per expert
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out, aux


def moe_apply(params: Dict[str, Tensor], x: Tensor, cfg: ArchConfig) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss).  The B * S tokens route
    together (row-major), padding and idle lanes included, as the
    reference's do."""
    b, s, d = x.shape
    t = b * s
    g = cfg.moe_group_size
    if g and t > g and t % g == 0:
        out, aux = _moe_groups(params, x.reshape(t // g, g, d), cfg)
    else:
        out, aux = _moe_groups(params, x.reshape(1, t, d), cfg)
    out = out.reshape(b, s, d)
    if cfg.dense_residual and "dense" in params:
        out = out + mlp_apply(params["dense"], x, cfg)
    if cfg.shared_expert and "shared" in params:
        out = out + mlp_apply(params["shared"], x, cfg)
    return out.to(x.dtype), aux
