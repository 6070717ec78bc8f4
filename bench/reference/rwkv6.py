"""Plain reference of RWKV-6 (Finch, arXiv:2404.05892) language-model
training: embedding, per layer a time mix and a channel mix each behind an
RMS norm on the residual stream, final RMS norm, untied head, mean
cross-entropy, the paper's auxiliary loss on the final hidden states
(``decorr.lm_aux``), global-norm clip and AdamW.

Every leaf is float32, and so is the arithmetic (or the control's
``precision``: every matrix product's operands and the scan's streams,
and for float8 every activation a bfloat16 model holds, rounded to it).  The
parameters are a flat dict in the layout the benchmark hands the system:
``embed`` (V, d), ``lm_head`` (d, V), ``final_norm`` (d,), and per layer
leaf ``blocks.pos0.<name>`` stacked over the layers (L, ...).  Norm weights
are stored as w - 1.

The time mix: token shift, the data-dependent lerp through low-rank
adapters (5 streams r, k, v, w, g), decay w = exp(-exp(d_t)), the WKV
recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T ;  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

per head, a group norm per head, the SiLU gate and the output product.
``wkv_scan`` is that recurrence step by step; ``wkv_chunked`` the same sum
by chunks of C positions (three products a chunk and the carried state),
which the tests hold against the scan and which the training reference
uses at full length.  The channel mix: token shift, squared-ReLU key,
value product, sigmoid receptance gate.

Each layer, and each block of rows of the head and its cross-entropy, is
recomputed in the backward pass (``torch.utils.checkpoint``), so the
reference fits beside its optimizer state at the timed sizes.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import decorr, numerics
from bench.reference import optim as ref_optim

Tensor = torch.Tensor
LORA_DIM = 32
CE_ROWS = 1024  # rows of the head and cross-entropy recomputed together


def leaf_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape, by name (the layer leaves stacked)."""
    d, f, v, hd, n = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], cfg["rwkv_head_dim"], cfg["n_layers"]
    layer = {
        "norm1": (d,), "norm2": (d,),
        "rwkv.mu_base": (d,), "rwkv.mu": (5, d), "rwkv.lora_a": (d, 5 * LORA_DIM), "rwkv.lora_b": (5, LORA_DIM, d),
        "rwkv.w_r": (d, d), "rwkv.w_k": (d, d), "rwkv.w_v": (d, d), "rwkv.w_g": (d, d), "rwkv.w_o": (d, d),
        "rwkv.decay_base": (d,), "rwkv.decay_lora_a": (d, LORA_DIM), "rwkv.decay_lora_b": (LORA_DIM, d),
        "rwkv.bonus_u": (d // hd, hd), "rwkv.ln_x": (d,),
        "rwkv.cmix_mu_k": (d,), "rwkv.cmix_mu_r": (d,), "rwkv.cmix_wk": (d, f), "rwkv.cmix_wv": (f, d),
        "rwkv.cmix_wr": (d, d),
    }
    shapes = {"embed": (v, d), "lm_head": (d, v), "final_norm": (d,)}
    shapes.update({f"blocks.pos0.{k}": (n,) + s for k, s in layer.items()})
    return shapes


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def token_shift(x: Tensor) -> Tensor:
    """x_{t-1}, zero before the first position."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def wkv_scan(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor) -> Tensor:
    """The recurrence step by step.  r / k / v / logw: (B, S, H, hd); u:
    (H, hd).  Returns y (B, S, H, hd)."""
    b, s, h, hd = r.shape
    state = r.new_zeros((b, h, hd, hd))
    w = torch.exp(logw)
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1)


def wkv_chunked(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, chunk: int,
                rnd: Callable[[Tensor], Tensor]) -> Tensor:
    """The recurrence by chunks of ``chunk`` positions (S a multiple of it),
    with cum_t the sum of log w up to t inside a chunk and m its midpoint:

        y_intra = tril_strict((r e^{cum_{t-1} - m}) (k e^{m - cum_tau})^T) v + (r . u k) v_t
        y_inter = (r e^{cum_{t-1}}) S_start ;  S_next = e^{cum_C} . S + (k e^{cum_C - cum_tau})^T v

    exponents clamped to +-60.  ``rnd`` rounds the streams that enter a
    product (the identity in float32)."""
    b, s, h, hd = r.shape
    nc = s // chunk

    def resh(t):
        return t.reshape(b, nc, chunk, h, hd)

    rc, kc, vc, lw = resh(r), resh(k), resh(v), resh(logw)
    cum = torch.cumsum(lw, dim=2)
    cum_prev = cum - lw
    cum_end = cum[:, :, -1:]
    mid = 0.5 * cum_end
    r_dec = rnd(rc * torch.exp(torch.clamp(cum_prev - mid, -60.0, 60.0)))
    k_dec = rnd(kc * torch.exp(torch.clamp(mid - cum, -60.0, 60.0)))
    r_in = rnd(rc * torch.exp(cum_prev))
    k_rem = rnd(kc * torch.exp(cum_end - cum))
    p_end = torch.exp(cum[:, :, -1])
    vs = rnd(vc)
    a = torch.einsum("bnthi,bnchi->bnhtc", r_dec, k_dec)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    a = rnd(torch.where(causal, a, torch.zeros((), dtype=a.dtype, device=a.device)))
    y = torch.einsum("bnhtc,bnchj->bnthj", a, vs)
    y = y + torch.einsum("bnthi,hi,bnthi->bnth", rc, u, kc)[..., None] * vc
    state = r.new_zeros((b, h, hd, hd))
    inter = []
    for c in range(nc):
        inter.append(torch.einsum("bthi,bhij->bthj", r_in[:, c], rnd(state)))
        state = p_end[:, c][..., None] * state + torch.einsum("bthi,bthj->bhij", k_rem[:, c], vs[:, c])
    return (y + torch.stack(inter, dim=1)).reshape(b, s, h, hd)


def time_mix(p: Dict[str, Tensor], x: Tensor, cfg: Dict, precision: str) -> Tensor:
    b, s, d = x.shape
    hd = cfg["rwkv_head_dim"]
    h = d // hd
    rnd, act = numerics.rounder(precision), numerics.activation(precision)

    def mm(a, w):
        return act(rnd(a) @ rnd(w))

    dx = act(token_shift(x) - x)
    x_base = act(x + dx * p["mu_base"])
    lora = act(torch.tanh(mm(x_base, p["lora_a"]))).reshape(b, s, 5, LORA_DIM)
    adj = act(torch.einsum("bsfl,fld->bsfd", rnd(lora), rnd(p["lora_b"])))
    mixed = act(x[:, :, None, :] + dx[:, :, None, :] * (p["mu"] + adj))
    xr, xk, xv, xw, xg = mixed.unbind(2)
    r = mm(xr, p["w_r"]).reshape(b, s, h, hd)
    k = mm(xk, p["w_k"]).reshape(b, s, h, hd)
    v = mm(xv, p["w_v"]).reshape(b, s, h, hd)
    g = act(F.silu(mm(xg, p["w_g"])))
    dec = p["decay_base"] + mm(act(torch.tanh(mm(xw, p["decay_lora_a"]))), p["decay_lora_b"])
    logw = -torch.exp(dec).reshape(b, s, h, hd)
    chunk = cfg.get("rwkv_chunk")
    if chunk and s % chunk == 0 and s > chunk:
        y = wkv_chunked(r, k, v, logw, p["bonus_u"], chunk, rnd)
    else:
        y = wkv_scan(rnd(r), rnd(k), rnd(v), logw, p["bonus_u"])
    mean = y.mean(dim=-1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(b, s, d) * p["ln_x"]
    return mm(act(y) * g, p["w_o"])


def channel_mix(p: Dict[str, Tensor], x: Tensor, precision: str) -> Tensor:
    rnd, act = numerics.rounder(precision), numerics.activation(precision)
    dx = act(token_shift(x) - x)
    xk = act(x + dx * p["cmix_mu_k"])
    xr = act(x + dx * p["cmix_mu_r"])
    k = act(torch.square(torch.relu(act(rnd(xk) @ rnd(p["cmix_wk"])))))
    kv = act(rnd(k) @ rnd(p["cmix_wv"]))
    return act(act(torch.sigmoid(act(rnd(xr) @ rnd(p["cmix_wr"])))) * kv)


def _layer(x: Tensor, names: Tuple[str, ...], cfg: Dict, precision: str, *leaves: Tensor) -> Tensor:
    p = dict(zip(names, leaves))
    eps = float(cfg.get("rms_eps", 1e-6))
    act = numerics.activation(precision)
    x = act(x + time_mix(p, act(rms_norm(x, p["norm1"], eps)), cfg, precision))
    return act(x + channel_mix(p, act(rms_norm(x, p["norm2"], eps)), precision))


def _ce_block(h: Tensor, w: Tensor, labels: Tensor, precision: str) -> Tensor:
    logits = numerics.matmul(h, w, precision)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def loss_fn(params: Dict[str, Tensor], tokens: Tensor, labels: Tensor, cfg: Dict, aux: Dict, perm, precision: str
            ) -> Tensor:
    """Mean cross-entropy + the auxiliary loss of one batch (B, S)."""
    prefix = "blocks.pos0."
    keys = [k for k in params if k.startswith(prefix)]
    names = tuple(k.rsplit(".", 1)[-1] for k in keys)
    stacked = [params[k] for k in keys]
    act = numerics.activation(precision)
    x = act(params["embed"][tokens.long()].float())
    for layer in range(cfg["n_layers"]):
        x = checkpoint(_layer, x, names, cfg, precision, *(t[layer] for t in stacked), use_reentrant=False)
    h = act(rms_norm(x, params["final_norm"], float(cfg.get("rms_eps", 1e-6))))
    flat, lab = h.reshape(-1, h.shape[-1]), labels.reshape(-1).long()
    total = 0.0
    for i in range(0, flat.shape[0], CE_ROWS):
        total = total + checkpoint(_ce_block, flat[i:i + CE_ROWS], params["lm_head"], lab[i:i + CE_ROWS], precision,
                                   use_reentrant=False)
    return total / flat.shape[0] + decorr.lm_aux(h, aux, perm, precision)


def follow(
    params: Dict[str, Tensor],
    batches: Sequence[Dict[str, Tensor]],
    perms: Sequence,
    cfg: Dict,
    aux: Dict,
    optimizer: Tuple[str, Dict],
    clip_norm,
    schedule: Callable[[int], float],
    precision: str = "fp32",
) -> Dict:
    """Steps 0 .. len(batches) - 1 from ``params`` (float32 leaves by name,
    updated in place).  Returns {"losses"; "first_grads": by leaf, the norm
    of the clipped gradient as the optimizer took it at step 0; "grads": by
    leaf, the norm of step 0's raw gradient}; the parameters' change is
    read by the caller from ``params`` afterwards."""
    if precision == "fp32":
        numerics.float32_exact()
    names = list(params)
    leaves = [params[n].requires_grad_(True) for n in names]
    opt = ref_optim.make(optimizer[0], leaves, optimizer[1])
    losses, first, raw = [], None, None
    for step, (batch, perm) in enumerate(zip(batches, perms)):
        value = loss_fn(params, batch["tokens"], batch["labels"], cfg, aux, perm, precision)
        grads = list(torch.autograd.grad(value, leaves))
        losses.append(float(value.detach()))
        del value
        if step == 0:
            raw = dict(zip(names, ref_optim.leaf_norms(grads)))
        ref_optim.clip_(grads, clip_norm)
        opt.step(schedule(step), grads)
        del grads
        if step == 0:
            first = dict(zip(names, ref_optim.leaf_norms(opt.first_gradients())))
    for t in leaves:
        t.requires_grad_(False)
    return {"losses": losses, "first_grads": first, "grads": raw}
