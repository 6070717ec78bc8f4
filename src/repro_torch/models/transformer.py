"""Generic decoder stack over a repeating block pattern (port of
``repro/models/transformer.py``).

Parameters keep the reference's stacked layout: ``params["blocks"]["pos{i}"]``
holds pattern position i's leaves with a leading ``repeats`` axis (the
reference's ``lax.scan`` axis), and layer ``r`` of that position reads the
contiguous slice ``leaf[r]``.  Where the reference scans, the port loops:
repetition by repetition, pattern position by position.  Caches are stacked
the same way per position: an attention position holds dense ``(repeats,
B, L, KV, hd)`` rows or a paged ``(repeats, P, page, KV, hd)`` pool (one
layer's pool ``pool[r]`` is a contiguous slab the paged-attention kernel
reads), a Mamba or RWKV position its per-slot recurrent state
``(repeats, B, ...)`` in both layouts.

A position's mixer is attention, Mamba or RWKV6 (``models.ssm``), its FFN a
dense MLP, an MoE (``models.moe``) or RWKV's channel mix.  The frontends:
``vision_stub`` models take ``embeds`` (precomputed patch embeddings) and
(3, B, S) M-RoPE positions; ``audio_codes`` models take (B, S, n_codebooks)
codes, sum one embedding per codebook and predict n_codebooks heads.

Modes (all through ``forward``):
  * score:    caches=None — full-sequence causal forward
  * prefill:  caches given, S > 1 — fills rows [0, S) in place (recurrent
    positions start from the state they are given and carry it forward);
    with ``chunked_prefill`` the chunk fills rows [cache_len, cache_len + S)
    and attends over the prefix already written (attention patterns only)
  * decode:   caches given, S == 1 — one token at ``cache_len`` (scalar or
    per-slot), through block tables when the caches are page pools
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ArchConfig, BlockSpec, dense_init, mlp_apply, rms_norm, softcap
from repro_torch.parallel import fsdp_tp
from repro_torch.parallel import sharding as shd

Tensor = torch.Tensor

# leaves the reference keeps in f32 whatever the param dtype
F32_LEAVES = ("router", "a_log", "d_skip", "decay_base", "bonus_u", "ln_x")
# leaves initialised to a constant (norm weights and biases: zero)
_CONST_INIT = {"dt_bias": -4.6, "mu_base": 0.5, "mu": 0.5, "decay_base": -5.0, "ln_x": 1.0, "d_skip": 1.0,
               "cmix_mu_k": 0.5, "cmix_mu_r": 0.5, "conv_b": 0.0, "bq": 0.0, "bk": 0.0, "bv": 0.0}
# leaves initialised to normal * scale (the rest: normal / sqrt(d_in))
_NORMAL_INIT = {"embed": 0.02, "conv_w": 0.1, "lora_b": 0.01, "decay_lora_b": 0.01, "bonus_u": 0.1}


class ModelOutput(NamedTuple):
    """``logits`` (f32; None when ``head=False``; (…, n_codebooks, V) for
    audio codes), final ``hidden`` states (pre-head, the decorrelation
    probe's target), the (updated) caches and ``aux`` (``moe_aux``: the
    MoE load-balance loss averaged over the layers; a host zero without
    MoE)."""

    logits: Optional[Tensor]
    hidden: Tensor
    caches: Optional[Dict[str, Any]]
    aux: Dict[str, Tensor]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_shapes(cfg: ArchConfig, spec: BlockSpec) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": (d,), "norm2": (d,)}
    if cfg.post_block_norm:
        p["post_norm1"] = (d,)
        p["post_norm2"] = (d,)
    if spec.mixer == "attn":
        p["attn"] = attn_lib.attn_shapes(cfg)
    elif spec.mixer == "mamba":
        p["mamba"] = ssm_lib.mamba_shapes(cfg)
    elif spec.mixer == "rwkv":
        p["rwkv"] = ssm_lib.rwkv_shapes(cfg)
    if spec.ffn == "dense":
        p["mlp"] = moe_lib.mlp_shapes(cfg, cfg.d_ff)
    elif spec.ffn == "moe":
        p["moe"] = moe_lib.moe_shapes(cfg)
    return p


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Nested dict of every parameter's shape (stacked block leaves lead with
    ``repeats``) — the layout ``init_params`` builds and ``params_from_jax``
    checks the reference's leaves against."""
    d, r = cfg.d_model, cfg.repeats

    def stack(tree):
        return {k: stack(v) if isinstance(v, dict) else (r,) + v for k, v in tree.items()}

    if cfg.frontend == "audio_codes":
        shapes: Dict[str, Any] = {"embed": (cfg.n_codebooks, cfg.vocab_size, d),
                                  "heads": (d, cfg.n_codebooks * cfg.vocab_size)}
    else:
        shapes = {"embed": (cfg.vocab_size, d)}
        if not cfg.tie_embeddings:
            shapes["lm_head"] = (d, cfg.vocab_size)
    shapes["final_norm"] = (d,)
    shapes["blocks"] = {f"pos{pos}": stack(_block_shapes(cfg, spec)) for pos, spec in enumerate(cfg.pattern)}
    return shapes


def _leaf_dtype(cfg: ArchConfig, name: str) -> torch.dtype:
    return torch.float32 if name in F32_LEAVES else cfg.param_dtype


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights from one seeded ``torch.Generator`` (on ``device``:
    ``cuda`` unless ``"cpu"`` is passed), with the reference's
    distributions: embeddings normal * 0.02, dense weights normal /
    sqrt(d_in), norm weights (stored as w - 1) and biases zero, and the
    reference's constants and small normals for the MoE router, Mamba and
    RWKV leaves.  The numbers differ from JAX's threefry stream; parity
    tests carry the reference's own weights across with ``params_from_jax``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def build(name: str, shape):
        if isinstance(shape, dict):
            return {k: build(k, s) for k, s in shape.items()}
        dt = _leaf_dtype(cfg, name)
        if "norm" in name:
            return torch.zeros(shape, dtype=dt, device=device)
        if name in _CONST_INIT:
            return torch.full(shape, _CONST_INIT[name], dtype=dt, device=device)
        if name == "a_log":  # log(1..N) on every channel
            n = shape[-1]
            a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
            return torch.log(a).expand(shape).contiguous()
        if name in _NORMAL_INIT:
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            return w.mul_(_NORMAL_INIT[name]).to(dt)
        return dense_init(gen, shape, dt, device)

    return build("", param_shapes(cfg))


def params_from_jax(cfg: ArchConfig, params, device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree (``repro.models.init_params``, leaves as
    numpy arrays or anything ``np.asarray`` takes) in the port's layout, on
    ``device`` (``cuda`` unless ``"cpu"`` is passed).  The stacked
    ``blocks/pos{i}`` leaves carry over as they are (attention, MLP, MoE
    router and experts, dense residual / shared expert, Mamba and RWKV
    leaves, audio embeddings and heads); every leaf's shape is checked
    against ``param_shapes(cfg)``, and the reference's f32 leaves stay f32."""
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
        dtype = _leaf_dtype(cfg, path.rsplit("/", 1)[-1])
        return torch.from_numpy(np.array(arr, np.float32)).to(device=device, dtype=dtype)

    return convert("", param_shapes(cfg), params)


class ParamTree(nn.Module):
    """A parameter tree (``init_params`` / ``params_from_jax``) held as an
    ``nn.Module``: every leaf becomes an ``nn.Parameter`` (sharing the
    leaf's storage), every sub-dict a child module of the same kind, so the
    optimizers, ``TrainState`` and ``checkpoint/`` take it as they take any
    model (``state_dict`` keys are the tree's paths joined by dots).
    ``tree()`` hands ``forward`` the nested dict of those parameters."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, sub in tree.items():
            if isinstance(sub, dict):
                self.add_module(key, ParamTree(sub))
            else:
                self.register_parameter(key, nn.Parameter(sub.detach()))

    def tree(self) -> Dict[str, Any]:
        """The nested dict of parameters, in ``forward``'s layout."""
        out: Dict[str, Any] = dict(self._parameters)
        out.update((key, mod.tree()) for key, mod in self._modules.items())
        return out


def layer_params(params: Dict[str, Any], name: str, r: int) -> Dict[str, Any]:
    """Views of layer ``r`` of pattern position ``name`` (no copies); a
    placed block's view carries its placement (``parallel/fsdp_tp``)."""

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else fsdp_tp.layer_view(v, v[r]) for k, v in tree.items()}

    return take(params["blocks"][name])


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def layer_caches(caches: Dict[str, Any], name: str, r: int) -> Dict[str, Tensor]:
    """Views of layer ``r`` of pattern position ``name``'s cache leaves (no
    copies; written in place); a placed block's view carries its placement
    (``parallel/fsdp_tp.place_caches``)."""
    return {k: fsdp_tp.layer_view(v, v[r]) for k, v in caches[name].items()}


def _position_cache(cfg: ArchConfig, spec: BlockSpec, batch: int, device) -> Dict[str, Tensor]:
    """A recurrent position's per-slot state (None for attention)."""
    if spec.mixer == "mamba":
        return ssm_lib.mamba_init_state(cfg, batch, device, cfg.repeats)
    if spec.mixer == "rwkv":
        return ssm_lib.rwkv_init_state(cfg, batch, device, cfg.repeats)
    return None


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device: DeviceLike = None) -> Dict[str, Any]:
    """Per-pattern-position dense decode state, on ``device`` (``cuda``
    unless ``"cpu"`` is passed): KV rows (repeats, batch, max_len, KV, hd)
    for attention, zero recurrent state (repeats, batch, ...) for Mamba /
    RWKV."""
    device = resolve_device(device)
    out = {}
    for pos, spec in enumerate(cfg.pattern):
        state = _position_cache(cfg, spec, batch, device)
        out[f"pos{pos}"] = state if state is not None else attn_lib.init_kv_cache(
            cfg, batch, max_len, device, cfg.repeats)
    return out


def init_paged_caches(cfg: ArchConfig, num_pages: int, page: int, device: DeviceLike = None, *,
                      batch: int = 1) -> Dict[str, Any]:
    """Paged decode state per pattern position, on ``device`` (``cuda``
    unless ``"cpu"`` is passed): attention gets a page pool (repeats,
    num_pages, page, KV, hd) shared by all slots through their block tables;
    Mamba / RWKV state stays dense per slot (``batch`` slots) — it is O(1)
    in the context, so paging it buys nothing."""
    device = resolve_device(device)
    out = {}
    for pos, spec in enumerate(cfg.pattern):
        state = _position_cache(cfg, spec, batch, device)
        out[f"pos{pos}"] = state if state is not None else attn_lib.init_paged_kv_cache(
            cfg, num_pages, page, device, cfg.repeats)
    return out


def cache_shardings_logical(cfg: ArchConfig) -> Dict[str, Dict[str, tuple]]:
    """Logical axes of each cache leaf (``launch/specs.cache_specs``)."""

    def one(spec: BlockSpec):
        if spec.mixer == "attn":
            return {
                "k": ("stack", "batch", "kv_seq", None, None),
                "v": ("stack", "batch", "kv_seq", None, None),
            }
        if spec.mixer == "mamba":
            return {
                "conv": ("stack", "batch", None, "ff"),
                "ssm": ("stack", "batch", "ff", None),
            }
        if spec.mixer == "rwkv":
            return {
                "wkv": ("stack", "batch", None, None, None),
                "shift_t": ("stack", "batch", None),
                "shift_c": ("stack", "batch", None),
            }
        return {}

    return {f"pos{pos}": one(spec) for pos, spec in enumerate(cfg.pattern)}


def is_paged(leafs) -> bool:
    """True for an attention position's page pool."""
    return "k_pages" in leafs


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------


def _apply_block(p, x, cfg: ArchConfig, spec: BlockSpec, positions, cache, cache_len, block_tables, impl,
                 chunked_prefill=False):
    """One layer: (x, the cache or state it leaves, its MoE aux loss or
    None where the layer has no MoE)."""
    aux = None
    h = rms_norm(x, p["norm1"], cfg.rms_eps)
    if spec.mixer == "attn":
        out, cache = attn_lib.attn_apply(
            p["attn"], h, cfg, spec, positions, cache, cache_len, block_tables=block_tables, impl=impl,
            chunked=chunked_prefill,
        )
    elif spec.mixer == "mamba":
        out, cache = ssm_lib.mamba_apply(p["mamba"], h, cfg, cache)
    elif spec.mixer == "rwkv":
        out, cache = ssm_lib.rwkv_time_mix(p["rwkv"], h, cfg, cache)
    else:
        out = torch.zeros_like(h)
    if cfg.post_block_norm:
        out = rms_norm(out, p["post_norm1"], cfg.rms_eps)
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.rms_eps)
    if spec.ffn == "dense":
        out = mlp_apply(p["mlp"], h, cfg)
    elif spec.ffn == "moe":
        out, aux = moe_lib.moe_apply(p["moe"], h, cfg)
    elif spec.ffn == "rwkv_cmix":
        out, cache = ssm_lib.rwkv_channel_mix(p["rwkv"], h, cfg, cache)
    else:
        out = torch.zeros_like(h)
    if cfg.post_block_norm:
        out = rms_norm(out, p["post_norm2"], cfg.rms_eps)
    return x + out, cache, aux


# the outputs ``remat_policy="dots"`` keeps (jax's ``dots_saveable``: every dot)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def _block_fn(cfg: ArchConfig, caches):
    """``_apply_block``, rematerialised when ``cfg.remat`` asks for it and
    autograd records a cache-free forward (a cache is written in place, and
    serving runs without grad)."""
    if not (cfg.remat and caches is None and torch.is_grad_enabled()):
        return _apply_block
    if cfg.remat_policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy must be 'nothing' or 'dots', got {cfg.remat_policy!r}")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
    # the recomputation sees the mesh and data-parallel axis the forward saw
    # (the MoE's capacity and claim positions span the data-parallel batch)
    state = shd.current_state()

    def block(*args):
        with shd.installed(state):
            return _apply_block(*args)

    # the stack draws no random numbers: no RNG state to stash and replay
    return functools.partial(checkpoint, block, use_reentrant=False, preserve_rng_state=False, **kw)


def _embed_inputs(params, cfg: ArchConfig, tokens: Optional[Tensor], embeds: Optional[Tensor]) -> Tensor:
    # gather the rows first, then cast: the reference casts the whole table
    # (fused by XLA); the values are the same
    cd = cfg.compute_dtype
    if embeds is not None:  # a modality frontend supplies the embeddings
        x = embeds.to(cd)
    else:
        # audio: (B, S, n_codebooks) codes, one table a codebook, summed; a
        # placed table is looked up vocabulary-parallel (``parallel/fsdp_tp``)
        x = fsdp_tp.embed_lookup(params["embed"], tokens, cd)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(cd)
    return x


def _head_leaf(params, cfg: ArchConfig):
    """(the head's leaf, True when it is the tied (V, d) embedding)."""
    if cfg.frontend == "audio_codes":
        return params["heads"], False
    if cfg.tie_embeddings:
        return params["embed"], True
    return params["lm_head"], False


def vocab_start(params, cfg: ArchConfig):
    """The first column of the flat (n_codebooks x) vocabulary that
    ``logits_from_hidden`` gives this rank, or None when it gives them all
    (the head is not a placed block split over ``model``)."""
    return fsdp_tp.vocab_start(*_head_leaf(params, cfg))


def logits_from_hidden(params, cfg: ArchConfig, h: Tensor) -> Tensor:
    """The LM head: tied embedding (or ``lm_head``; audio: the n_codebooks
    ``heads``, (…, n_codebooks, V)), f32, final softcap.  A placed head
    split over ``model`` (``parallel/fsdp_tp``) gives this rank's columns of
    the flat (n_codebooks x) vocabulary, (…, C), from ``vocab_start``."""
    leaf, tied = _head_leaf(params, cfg)
    start, w = fsdp_tp.head_columns(leaf, tied)
    w = w.to(cfg.compute_dtype)
    logits = (h if start is None else fsdp_tp.enter_tp(h)) @ (w.T if tied else w)
    if start is None and cfg.frontend == "audio_codes":
        logits = logits.reshape(*h.shape[:-1], cfg.n_codebooks, cfg.vocab_size)
    return softcap(logits.float(), cfg.final_softcap)


def forward(
    params: Dict[str, Any],
    cfg: ArchConfig,
    tokens: Optional[Tensor] = None,
    positions: Optional[Tensor] = None,
    caches: Optional[Dict[str, Any]] = None,
    cache_len=None,
    block_tables: Optional[Tensor] = None,
    impl: Optional[str] = None,
    head: bool = True,
    chunked_prefill: bool = False,
    embeds: Optional[Tensor] = None,
) -> ModelOutput:
    """Run the stack on (B, S) token ids ((B, S, n_codebooks) codes for
    audio), or on (B, S, d) ``embeds``.  ``positions``: (B, S), or (3, B, S)
    M-RoPE streams; by default ``cache_len`` + 0..S-1 (every stream alike
    under M-RoPE).  Caches and recurrent state are updated in place and
    returned.  ``head=False`` skips the LM head (a prefill that needs one
    row's logits computes them from ``hidden`` itself); ``impl`` picks the
    paged attention route (see ``attention.use_kernel``);
    ``chunked_prefill`` writes the S rows at ``cache_len`` (positions start
    there too) and attends across the prefix already in the cache."""
    x = _embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    if positions is None:
        base = torch.arange(s, dtype=torch.int64, device=x.device)[None, :]
        if cache_len is not None:
            vec = torch.is_tensor(cache_len) and cache_len.ndim == 1
            base = base + (cache_len.long()[:, None] if vec else cache_len)
        positions = base.expand(b, s)
        if cfg.mrope:
            positions = positions[None].expand(3, b, s)
    aux = None  # a device tensor only once a MoE layer has run
    block = _block_fn(cfg, caches)
    for r in range(cfg.repeats):
        for pos, spec in enumerate(cfg.pattern):
            name = f"pos{pos}"
            cache = None if caches is None else layer_caches(caches, name, r)
            x, new, a = block(
                layer_params(params, name, r), x, cfg, spec, positions, cache, cache_len, block_tables, impl,
                chunked_prefill,
            )
            if a is not None:
                aux = a if aux is None else aux + a
            if cache is not None and spec.mixer != "attn":
                # recurrent state comes back as new tensors: write it in place,
                # in the layer's (placed) block shape and never broadcast
                for k, v in new.items():
                    dst = caches[name][k][r]
                    if v.shape != dst.shape:
                        raise ValueError(f"{name}/{k}: new state {tuple(v.shape)} does not fit the layer's "
                                         f"{tuple(dst.shape)} block")
                    dst.copy_(v)
    h = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = logits_from_hidden(params, cfg, h) if head else None
    # no MoE layer: a host zero, so attention-only stacks issue no device op for it
    aux = torch.zeros(()) if aux is None else aux / max(cfg.n_layers, 1)
    return ModelOutput(logits=logits, hidden=h, caches=caches, aux={"moe_aux": aux})
