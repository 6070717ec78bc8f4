"""GQA attention with RoPE, local / global windows and logit softcap, over
a dense KV cache (prefill, chunked prefill, scalar and per-slot decode) or a
paged one (block-table decode).  Port of ``repro/models/attention.py``.

The reference is functional (``.at[].set`` returns a new cache); here the
cache tensors are updated in place (``index_put_``), so a decode step writes
the new token's k / v straight into the caller's pool and returns the same
dict.  Prompts longer than ``cfg.attn_chunk_threshold`` (a multiple of
``cfg.attn_chunk_size``) take the chunked-causal (flash-style) prefill:
an online softmax over the static list of causal chunk pairs, so the score
work is the causal half and no (S, S) score matrix is built.  It is plain
PyTorch, as the reference's is plain JAX (no Pallas kernel there); SDPA
cannot stand in, since it cannot apply gemma's logit softcap.  Qwen2-VL's
M-RoPE rotates by three position streams ((3, B, S) positions).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels.paged_attention.kernel import paged_decode_attention
from repro_torch.models.common import ArchConfig, BlockSpec, softcap
from repro_torch.parallel import fsdp_tp
from repro_torch.parallel import sharding as shd

Tensor = torch.Tensor

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def _rope_freqs(hd: int, theta: float, device) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Rotates the two halves."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: Tensor, positions: Tensor, theta: float, sections: Tuple[int, ...]) -> Tensor:
    """Qwen2-VL multimodal RoPE.  positions: (3, B, S) — the temporal, height
    and width streams; ``sections`` split the hd / 2 frequencies among them
    (the first ``sections[0]`` rotate by stream 0, and so on)."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = _rope_freqs(hd, theta, x.device)
    ang_streams = positions[..., None].float() * freqs  # (3, B, S, hd/2)
    sel = torch.cat([torch.full((n,), i, dtype=torch.long) for i, n in enumerate(sections)]).to(x.device)
    ang = torch.gather(ang_streams, 0, sel.expand_as(ang_streams)[:1])[0]  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def attn_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf shapes of one layer's attention parameters."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(kv * hd,), bv=(kv * hd,))
    return shapes


def _project_qkv(params, x: Tensor, cfg: ArchConfig, positions: Tensor, weight=None, heads=None):
    """(q, k, v) with RoPE applied: (B, S, heads, hd).  ``weight(name)``
    gives the leaf to multiply by (default: the leaf in the compute dtype)
    and ``heads`` the (q, kv) heads it yields (default: all of them); the
    2-D layout passes a rank's head blocks."""
    b, s, _ = x.shape
    h, kv = heads or (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.hd
    cd = cfg.compute_dtype
    weight = weight or (lambda name: params[name].to(cd))
    q = x @ weight("wq")
    k = x @ weight("wk")
    v = x @ weight("wv")
    if cfg.qkv_bias:
        q = q + weight("bq")
        k = k + weight("bk")
        v = v + weight("bv")
    q, k = q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        pos2d = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos2d, cfg.rope_theta)
        k = apply_rope(k, pos2d, cfg.rope_theta)
    v = v.reshape(b, s, kv, hd)
    # layout annotations, the reference's line for line (``shard`` is a no-op
    # in eager PyTorch: no compiler to hint)
    if cfg.seq_shard_attention:
        mesh = shd.current_mesh()
        n_model = 1
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            for ax in shd.current_rules().get("heads") or ():
                if ax in names:
                    n_model *= int(mesh.shape[names.index(ax)])
        if h % max(n_model, 1) != 0:
            # heads unshardable: shard query-sequence over `model`; k/v stay
            # replicated so scores/softmax/out are fully shard-local.
            q = shd.shard(q, ("batch", "kv_seq", None, None))
            return q, k, v
    q = shd.shard(q, ("batch", None, "heads", None))
    return q, k, v


def _repeat_kv(x: Tensor, n_rep: int) -> Tensor:
    """(B, S, KV, hd) -> (B, S, KV * n_rep, hd): head h reads kv head h // n_rep."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def _scale(cfg: ArchConfig, hd: int) -> float:
    return cfg.attn_scale or (1.0 / math.sqrt(hd))


def _softmax_attend(scores: Tensor, mask: Tensor, v: Tensor, dtype) -> Tensor:
    """Masked softmax over the last axis (masked logits at NEG_INF carry
    exactly 0 probability mass), then probs @ v: (B, H, Q, K) x (B, K, H, hd)."""
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# Full (materialized-scores) attention — prefill and scoring
# ---------------------------------------------------------------------------


def _full_attention(q, k, v, cfg: ArchConfig, spec: BlockSpec) -> Tensor:
    b, s, h, hd = q.shape
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _scale(cfg, hd)
    scores = softcap(scores, cfg.attn_softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = ki <= qi
    if spec.attn_type == "local":
        mask &= ki > qi - cfg.window_size
    return _softmax_attend(scores, mask[None, None], v, q.dtype)


# ---------------------------------------------------------------------------
# Chunked-causal (flash-style) attention — long prefill
# ---------------------------------------------------------------------------


def _chunked_attention(q, k, v, cfg: ArchConfig, spec: BlockSpec, chunk: int) -> Tensor:
    """Online softmax over the static list of causal chunk pairs (i, j <= i),
    as the reference scans it: each pair's scores are (B, H, chunk, chunk),
    and only the causal half of the pairs runs.  A local layer keeps the
    pairs whose chunk distance is within ``span`` of the window."""
    b, s, h, hd = q.shape
    assert s % chunk == 0, (s, chunk)
    scale = _scale(cfg, hd)
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    nc = s // chunk
    pairs = np.array([(i, j) for i in range(nc) for j in range(i + 1)], np.int64)
    if spec.attn_type == "local":
        span = -(-cfg.window_size // chunk)  # chunks that can be in-window
        pairs = pairs[pairs[:, 0] - pairs[:, 1] <= span]
    acc = [torch.zeros((b, chunk, h, hd), dtype=torch.float32, device=q.device) for _ in range(nc)]
    m = [torch.full((b, chunk, h), NEG_INF, dtype=torch.float32, device=q.device) for _ in range(nc)]
    l = [torch.zeros((b, chunk, h), dtype=torch.float32, device=q.device) for _ in range(nc)]
    local = torch.arange(chunk, device=q.device)
    for i, j in pairs.tolist():
        qb = q[:, i * chunk:(i + 1) * chunk]
        kb = k[:, j * chunk:(j + 1) * chunk]
        vb = v[:, j * chunk:(j + 1) * chunk]
        sc = torch.einsum("bqhd,bkhd->bhqk", qb, kb).float() * scale
        sc = softcap(sc, cfg.attn_softcap)
        gq = (i * chunk + local)[:, None]
        gk = (j * chunk + local)[None, :]
        mask = gk <= gq
        if spec.attn_type == "local":
            mask &= gk > gq - cfg.window_size
        sc = torch.where(mask[None, None], sc, NEG_INF)
        m_new = torch.maximum(m[i], sc.amax(dim=-1).transpose(1, 2))  # (b, q, h)
        corr = torch.exp(m[i] - m_new)
        p = torch.exp(sc - m_new.transpose(1, 2)[..., None])  # (b, h, q, k)
        l[i] = l[i] * corr + p.sum(dim=-1).transpose(1, 2)
        acc[i] = acc[i] * corr[..., None] + torch.einsum("bhqk,bkhd->bqhd", p.to(qb.dtype), vb).float()
        m[i] = m_new
    out = torch.cat([a / torch.clamp(li[..., None], min=1e-30) for a, li in zip(acc, l)], dim=1)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(
    cfg: ArchConfig, batch: int, max_len: int, device: DeviceLike = None, repeats: int = 1
) -> Dict[str, Tensor]:
    """Dense per-slot cache rows, (repeats, batch, max_len, KV, hd) in the
    compute dtype (one pattern position's stacked layers), on ``device``
    (``cuda`` unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    shape = (repeats, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {k: torch.zeros(shape, dtype=cfg.compute_dtype, device=device) for k in ("k", "v")}


def init_paged_kv_cache(
    cfg: ArchConfig, num_pages: int, page: int, device: DeviceLike = None, repeats: int = 1
) -> Dict[str, Tensor]:
    """Block-table layout: one physical pool of ``num_pages`` pages of
    ``page`` tokens per layer, (repeats, num_pages, page, KV, hd), shared by
    all slots through their block tables (page 0 is the allocator's sentinel
    — written by masked lanes, never read unmasked), on ``device`` (``cuda``
    unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    shape = (repeats, num_pages, page, cfg.n_kv_heads, cfg.hd)
    return {k: torch.zeros(shape, dtype=cfg.compute_dtype, device=device) for k in ("k_pages", "v_pages")}


def _decode_attention(q, cache_k, cache_v, cache_len, cfg: ArchConfig, spec: BlockSpec) -> Tensor:
    """q: (B, 1, H, hd); cache_(k|v): (B, L, KV, hd); cache_len: an int, a
    0-d tensor, or (B,) per-row lengths (continuous batching: each slot
    decodes at its own position)."""
    b, _, h, hd = q.shape
    k = _repeat_kv(cache_k, h // cache_k.shape[2])
    v = _repeat_kv(cache_v, h // cache_v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _scale(cfg, hd)
    scores = softcap(scores, cfg.attn_softcap)
    ki = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    cl = cache_len.reshape(b, 1, 1, 1) if torch.is_tensor(cache_len) and cache_len.ndim == 1 else cache_len
    mask = ki < cl
    if spec.attn_type == "local":
        mask &= ki >= cl - cfg.window_size
    return _softmax_attend(scores, mask, v, q.dtype)


def use_kernel(x: Tensor, impl: Optional[str]) -> bool:
    """Route of the paged attention: ``best_impl("paged_attention")``, the
    CUDA kernel for a CUDA tensor and the gather + ``_decode_attention``
    route for a CPU tensor unless an override pins one.  ``impl="plain"``
    forces the gather route (on-card comparison); ``impl="kernel"`` forces
    the kernel wrapper (on the CPU it runs the kernel's plain version)."""
    if impl not in (None, "kernel", "plain"):
        raise ValueError(f"impl must be None, 'kernel' or 'plain', got {impl!r}")
    if impl is None:
        from repro_torch.tune.dispatch import best_impl

        impl = best_impl("paged_attention", x.device)
    return impl == "kernel"


def _paged_decode(q, k, v, cache, cache_len, block_tables, cfg: ArchConfig, spec: BlockSpec, impl=None):
    """Single-token decode through block-table pages: scatter the new token's
    k / v into row ``len % page`` of page ``block_tables[b, len // page]``
    (in place), then attend over the table.

    The plain route gathers the pages back into a (B, NB * page, KV, hd)
    dense view and reuses ``_decode_attention`` verbatim: when NB * page
    equals the dense pool's max_len (the engine guarantees it), paged decode
    is bit-identical to the dense path — rows past ``cache_len`` differ only
    in masked positions whose probability mass is exactly 0.  On a CUDA
    tensor the block-table kernel (``kernels/paged_attention``) attends
    instead and never materializes the gather (``best_impl``, as in the
    reference).
    """
    b, _, h, hd = q.shape
    kp, vp = cache["k_pages"], cache["v_pages"]
    page = kp.shape[1]
    cl = cache_len if torch.is_tensor(cache_len) and cache_len.ndim == 1 else torch.full(
        (b,), int(cache_len), dtype=torch.int32, device=q.device
    )
    cl = cl.long()
    tables = block_tables.long()
    lanes = torch.arange(b, device=q.device)
    phys, row = tables[lanes, cl // page], cl % page
    kw, vw = k[:, 0], v[:, 0]
    if cfg.n_experts:
        # every free lane writes row 0 of the sentinel page and reads it back,
        # and MoE capacity lets a free lane's row take a real token's seat: so
        # lanes that share a row all write the last such lane's values (the
        # reference's sequential scatter), not whichever write lands last on
        # the card
        tgt = phys * page + row
        last = torch.where(tgt[:, None] == tgt[None, :], lanes, -1).amax(dim=1)
        kw, vw = kw[last], vw[last]
    kp[phys, row] = kw.to(kp.dtype)
    vp[phys, row] = vw.to(vp.dtype)
    if use_kernel(kp, impl):
        out = paged_decode_attention(
            q[:, 0].float().contiguous(), kp, vp,
            block_tables.to(torch.int32).contiguous(), (cl + 1).to(torch.int32),
            scale=_scale(cfg, hd),
            softcap=cfg.attn_softcap or 0.0,
            window=cfg.window_size if spec.attn_type == "local" else 0,
        )
        return out[:, None].to(q.dtype), cache
    kv = kp.shape[2]
    kd = kp[tables].reshape(b, -1, kv, hd)
    vd = vp[tables].reshape(b, -1, kv, hd)
    return _decode_attention(q, kd, vd, cl + 1, cfg, spec), cache


def _offset_prefill_attention(q, cache_k, cache_v, offset: int, cfg: ArchConfig, spec: BlockSpec) -> Tensor:
    """Chunked serving prefill: queries at absolute positions
    [offset, offset + S) attend to cache rows [0, offset + S) — causal
    across the already-written prefix AND within the chunk.  The caches
    already hold the chunk's k / v at [offset, offset + S)."""
    b, s, h, hd = q.shape
    k = _repeat_kv(cache_k, h // cache_k.shape[2])
    v = _repeat_kv(cache_v, h // cache_v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _scale(cfg, hd)
    scores = softcap(scores, cfg.attn_softcap)
    qi = int(offset) + torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = ki <= qi
    if spec.attn_type == "local":
        mask &= ki > qi - cfg.window_size
    return _softmax_attend(scores, mask[None, None], v, q.dtype)


def _scoring_attention(params, x: Tensor, cfg: ArchConfig, spec: BlockSpec, positions: Tensor,
                       cache: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """The forward over the full sequence (a prefill writes k / v into rows
    [0, S) of ``cache`` first).  On placed blocks (``parallel/fsdp_tp``, the
    2-D train step) each weight is gathered over ``data``; with ``wo`` split
    over ``model`` (row-parallel, its output all-reduced over ``model``) a
    rank computes its q heads where whole q heads fall on each rank, and its
    kv heads where whole kv heads do too (a rank's q heads then read exactly
    its kv heads).  A leaf that does not split on a head boundary is
    gathered over ``model`` and computed whole: whole q heads give whole
    outputs, of which the rank keeps the columns of its ``wo`` rows; whole
    kv heads are indexed by the rank's q heads.  A whole leaf passes through
    every gather."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.compute_dtype
    model = fsdp_tp.MODEL
    tp = fsdp_tp.split_over(params["wo"], model)
    m = shd.axis_size(model) if tp else 1
    idx = shd.axis_index(model) if tp else 0
    q_split = tp and h % m == 0 and fsdp_tp.split_over(params["wq"], model)
    kv_split = q_split and kv % m == 0 and fsdp_tp.split_over(params["wk"], model)
    if tp:
        x = fsdp_tp.enter_tp(x)
    split = {"wq": q_split, "bq": q_split, "wk": kv_split, "bk": kv_split, "wv": kv_split, "bv": kv_split,
             "wo": tp}

    def weight(name):
        return fsdp_tp.gather(params[name], model=not split[name], repeated=not tp, tp=tp).to(cd)

    hl = h // m if q_split else h
    kvl = kv // m if kv_split else kv
    q, k, v = _project_qkv(params, x, cfg, positions, weight=weight, heads=(hl, kvl))
    if q_split and not kv_split:
        # whole kv heads: the ones this rank's q heads read, one a q head
        sel = torch.div(idx * hl + torch.arange(hl, device=q.device), h // kv, rounding_mode="floor")
        k, v = k.index_select(2, sel), v.index_select(2, sel)
    b, s = x.shape[:2]
    if cache is not None:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    if s > cfg.attn_chunk_threshold and s % cfg.attn_chunk_size == 0:
        out = _chunked_attention(q, k, v, cfg, spec, cfg.attn_chunk_size)
    else:
        out = _full_attention(q, k, v, cfg, spec)
    out = out.reshape(b, s, hl * hd)
    if tp and not q_split:
        cols = h * hd // m
        out = out[..., idx * cols:(idx + 1) * cols]
    out = out @ weight("wo")
    return fsdp_tp.exit_tp(out) if tp else out


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def attn_apply(
    params: Dict[str, Tensor],
    x: Tensor,
    cfg: ArchConfig,
    spec: BlockSpec,
    positions: Tensor,
    cache: Optional[Dict[str, Tensor]] = None,
    cache_len=None,
    block_tables: Optional[Tensor] = None,
    impl: Optional[str] = None,
    chunked: bool = False,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """Returns (output (B, S, d), the cache or None).

    * cache is None: scoring forward over the full sequence.
    * cache given, S == 1: single-token decode (writes position cache_len,
      in place).  A cache with ``k_pages`` routes through the paged
      (block-table) path; otherwise ``cache_len`` is a scalar or (B,).
    * cache given, S > 1: prefill — writes rows [0, S) and attends causally;
      with ``chunked=True`` the chunk is written at rows
      [cache_len, cache_len + S) instead and attends across the prefix
      already written (incremental prefill).

    The scoring forward and the prefill take ``_scoring_attention``, which
    also runs placed blocks (``parallel/fsdp_tp``, the 2-D train step).
    """
    b, s, _ = x.shape
    if cache is None or (s > 1 and not chunked):
        return _scoring_attention(params, x, cfg, spec, positions, cache), cache
    h, hd = cfg.n_heads, cfg.hd
    cd = cfg.compute_dtype
    q, k, v = _project_qkv(params, x, cfg, positions)
    if s == 1:
        if "k_pages" in cache:
            out, cache = _paged_decode(q, k, v, cache, cache_len, block_tables, cfg, spec, impl)
        else:
            ck, cv = cache["k"], cache["v"]
            if torch.is_tensor(cache_len) and cache_len.ndim == 1:
                # per-slot decode: row i writes its token at its own position
                rows = torch.arange(b, device=x.device)
                ck[rows, cache_len.long()] = k[:, 0]
                cv[rows, cache_len.long()] = v[:, 0]
            else:
                ck[:, int(cache_len)] = k[:, 0]
                cv[:, int(cache_len)] = v[:, 0]
            out = _decode_attention(q, ck, cv, cache_len + 1, cfg, spec)
        return out.reshape(b, s, h * hd) @ params["wo"].to(cd), cache
    off = int(cache_len)
    cache["k"][:, off:off + s] = k
    cache["v"][:, off:off + s] = v
    out = _offset_prefill_attention(q, cache["k"], cache["v"], off, cfg, spec)
    return out.reshape(b, s, h * hd) @ params["wo"].to(cd), cache
