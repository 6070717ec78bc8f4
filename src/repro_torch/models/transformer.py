"""Generic decoder stack over a repeating block pattern (port of
``repro/models/transformer.py``, dense attention families).

Parameters keep the reference's stacked layout: ``params["blocks"]["pos{i}"]``
holds pattern position i's leaves with a leading ``repeats`` axis (the
reference's ``lax.scan`` axis), and layer ``r`` of that position reads the
contiguous slice ``leaf[r]``.  Where the reference scans, the port loops:
repetition by repetition, pattern position by position.  Caches are stacked
the same way — dense ``(repeats, B, L, KV, hd)`` or paged ``(repeats, P,
page, KV, hd)`` per position — so one layer's page pool ``pool[r]`` is a
contiguous slab the paged-attention kernel reads.

Modes (all through ``forward``):
  * score:    caches=None — full-sequence causal forward
  * prefill:  caches given, S > 1 — fills rows [0, S) in place; with
    ``chunked_prefill`` the chunk fills rows [cache_len, cache_len + S) and
    attends over the prefix already written
  * decode:   caches given, S == 1 — one token at ``cache_len`` (scalar or
    per-slot), through block tables when the caches are page pools
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    ArchConfig,
    BlockSpec,
    check_supported,
    dense_init,
    mlp_apply,
    rms_norm,
    softcap,
)

Tensor = torch.Tensor


class ModelOutput(NamedTuple):
    """``logits`` (f32; None when ``head=False``), final ``hidden`` states
    (pre-head, the decorrelation probe's target) and the (updated) caches."""

    logits: Optional[Tensor]
    hidden: Tensor
    caches: Optional[Dict[str, Any]]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Nested dict of every parameter's shape (stacked block leaves lead with
    ``repeats``) — the layout ``init_params`` builds and ``params_from_jax``
    checks the reference's leaves against."""
    check_supported(cfg)
    d, r = cfg.d_model, cfg.repeats
    shapes: Dict[str, Any] = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    mlp = {"w_in": (d, cfg.d_ff), "w_out": (cfg.d_ff, d)}
    if cfg.activation in ("swiglu", "geglu"):
        mlp["w_gate"] = (d, cfg.d_ff)
    blocks = {}
    for pos, _spec in enumerate(cfg.pattern):
        p: Dict[str, Any] = {"norm1": (r, d), "norm2": (r, d)}
        if cfg.post_block_norm:
            p["post_norm1"] = (r, d)
            p["post_norm2"] = (r, d)
        p["attn"] = {k: (r,) + s for k, s in attn_lib.attn_shapes(cfg).items()}
        p["mlp"] = {k: (r,) + s for k, s in mlp.items()}
        blocks[f"pos{pos}"] = p
    shapes["blocks"] = blocks
    return shapes


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights from one seeded ``torch.Generator`` (on ``device``:
    ``cuda`` unless ``"cpu"`` is passed), with the reference's
    distributions: embedding normal * 0.02, dense weights normal /
    sqrt(d_in), biases and norm weights (stored as w - 1) zero.  The numbers
    differ from JAX's threefry stream; parity tests carry the reference's
    own weights across with ``params_from_jax``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pd = cfg.param_dtype

    def build(name: str, shape):
        if isinstance(shape, dict):
            return {k: build(k, s) for k, s in shape.items()}
        if "norm" in name or name in ("bq", "bk", "bv"):
            return torch.zeros(shape, dtype=pd, device=device)
        if name == "embed":
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            return (w * 0.02).to(pd)
        return dense_init(gen, shape, pd, device)

    return build("", param_shapes(cfg))


def params_from_jax(cfg: ArchConfig, params, device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree (``repro.models.init_params``, leaves as
    numpy arrays or anything ``np.asarray`` takes) in the port's layout, on
    ``device`` (``cuda`` unless ``"cpu"`` is passed).  The stacked
    ``blocks/pos{i}`` leaves carry over as they are; every leaf's shape is
    checked against ``param_shapes(cfg)``."""
    device = resolve_device(device)

    def convert(path: str, shape, leaf):
        if isinstance(shape, dict):
            missing = set(shape) - set(leaf)
            if missing:
                raise KeyError(f"reference params lack {sorted(missing)} under {path or '/'}")
            return {k: convert(f"{path}/{k}", s, leaf[k]) for k, s in shape.items()}
        arr = np.asarray(leaf)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: reference shape {arr.shape} != port shape {shape}")
        return torch.from_numpy(np.array(arr, np.float32)).to(device=device, dtype=cfg.param_dtype)

    return convert("", param_shapes(cfg), params)


def layer_params(params: Dict[str, Any], name: str, r: int) -> Dict[str, Any]:
    """Views of layer ``r`` of pattern position ``name`` (no copies)."""

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[r] for k, v in tree.items()}

    return take(params["blocks"][name])


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device: DeviceLike = None) -> Dict[str, Any]:
    """Per-pattern-position dense KV caches, (repeats, batch, max_len, KV, hd),
    on ``device`` (``cuda`` unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    return {
        f"pos{pos}": attn_lib.init_kv_cache(cfg, batch, max_len, device, cfg.repeats)
        for pos in range(len(cfg.pattern))
    }


def init_paged_caches(cfg: ArchConfig, num_pages: int, page: int, device: DeviceLike = None) -> Dict[str, Any]:
    """Per-pattern-position page pools, (repeats, num_pages, page, KV, hd),
    shared by all slots through their block tables, on ``device`` (``cuda``
    unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    return {
        f"pos{pos}": attn_lib.init_paged_kv_cache(cfg, num_pages, page, device, cfg.repeats)
        for pos in range(len(cfg.pattern))
    }


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------


def _apply_block(p, x, cfg: ArchConfig, spec: BlockSpec, positions, cache, cache_len, block_tables, impl,
                 chunked_prefill=False):
    h = rms_norm(x, p["norm1"], cfg.rms_eps)
    out, cache = attn_lib.attn_apply(
        p["attn"], h, cfg, spec, positions, cache, cache_len, block_tables=block_tables, impl=impl,
        chunked=chunked_prefill,
    )
    if cfg.post_block_norm:
        out = rms_norm(out, p["post_norm1"], cfg.rms_eps)
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.rms_eps)
    out = mlp_apply(p["mlp"], h, cfg)
    if cfg.post_block_norm:
        out = rms_norm(out, p["post_norm2"], cfg.rms_eps)
    return x + out


def _embed_inputs(params, cfg: ArchConfig, tokens: Tensor) -> Tensor:
    # gather the rows first, then cast: the reference casts the whole table
    # (fused by XLA); the values are the same
    x = params["embed"][tokens].to(cfg.compute_dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(cfg.compute_dtype)
    return x


def logits_from_hidden(params, cfg: ArchConfig, h: Tensor) -> Tensor:
    """The LM head: tied embedding (or ``lm_head``), f32, final softcap."""
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(cd).T
    else:
        logits = h @ params["lm_head"].to(cd)
    return softcap(logits.float(), cfg.final_softcap)


def forward(
    params: Dict[str, Any],
    cfg: ArchConfig,
    tokens: Tensor,
    positions: Optional[Tensor] = None,
    caches: Optional[Dict[str, Any]] = None,
    cache_len=None,
    block_tables: Optional[Tensor] = None,
    impl: Optional[str] = None,
    head: bool = True,
    chunked_prefill: bool = False,
) -> ModelOutput:
    """Run the stack on (B, S) token ids.  Caches are updated in place and
    returned.  ``head=False`` skips the LM head (a prefill that needs one
    row's logits computes them from ``hidden`` itself); ``impl`` picks the
    paged attention route (see ``attention.use_kernel``);
    ``chunked_prefill`` writes the S rows at ``cache_len`` (positions start
    there too) and attends across the prefix already in the cache."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, tokens)
    b, s, _ = x.shape
    if positions is None:
        base = torch.arange(s, dtype=torch.int64, device=x.device)[None, :]
        if cache_len is not None:
            vec = torch.is_tensor(cache_len) and cache_len.ndim == 1
            base = base + (cache_len.long()[:, None] if vec else cache_len)
        positions = base.expand(b, s)
    for r in range(cfg.repeats):
        for pos, spec in enumerate(cfg.pattern):
            name = f"pos{pos}"
            cache = None if caches is None else {k: v[r] for k, v in caches[name].items()}
            x = _apply_block(
                layer_params(params, name, r), x, cfg, spec, positions, cache, cache_len, block_tables, impl,
                chunked_prefill,
            )
    h = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = logits_from_hidden(params, cfg, h) if head else None
    return ModelOutput(logits=logits, hidden=h, caches=caches)
