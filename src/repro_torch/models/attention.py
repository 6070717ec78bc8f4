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

On placed parameters and caches (``parallel/fsdp_tp``: heads over
``model``, each dense cache's rows over ``model``, the reference's
``kv_seq`` layout) a prefill writes each rank's block of rows and a decode
attends each rank's rows with the paged-attention kernel and merges the
ranks' partial softmaxes by their log-sum-exps (``_placed_decode``), where
the reference's GSPMD partitioner derives the same merge from its sharding
annotations.  Where the heads do not split over ``model``,
``cfg.seq_shard_attention`` splits the query rows over it instead (the
train step's and the prefill's ``_scoring_attention``), as the reference's
``("batch", "kv_seq")`` annotation of q asks GSPMD to.

A one-token decode over an unplaced dense cache keeps ``_decode_attention``
(plain PyTorch on every device, as the reference's dense decode is plain
JAX with no Pallas kernel).  ``_placed_decode`` on unplaced leaves would do
the same work through the kernel, but with q in f32 where
``_decode_attention`` scores in the compute dtype: the dense engine's
outputs would move, and with them the paged plain route's bit-for-bit
identity to the dense engine (``_paged_decode``) that the tests and the
GPU smoke hold.  Merging the two decodes is a planned simplification.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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


def _project_qkv(params, x: Tensor, cfg: ArchConfig, positions: Tensor, weight=None, heads=None, q_rows=None):
    """(q, k, v) with RoPE applied: (B, S, heads, hd).  ``weight(name)``
    gives the leaf to multiply by (default: the leaf in the compute dtype)
    and ``heads`` the (q, kv) heads it yields (default: all of them); the
    2-D layout passes a rank's head blocks.  ``q_rows`` = (lo, n): q of
    rows [lo, lo + n) alone, (B, n, heads, hd) (the sequence-split
    attention's query block); k and v cover every row."""
    b, s, _ = x.shape
    h, kv = heads or (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.hd
    cd = cfg.compute_dtype
    weight = weight or (lambda name: params[name].to(cd))
    lo, n = q_rows or (0, s)
    q = x[:, lo:lo + n] @ weight("wq")
    k = x @ weight("wk")
    v = x @ weight("wv")
    if cfg.qkv_bias:
        q = q + weight("bq")
        k = k + weight("bk")
        v = v + weight("bv")
    q, k = q.reshape(b, n, h, hd), k.reshape(b, s, kv, hd)
    q_pos = positions[..., lo:lo + n]
    if cfg.mrope:
        q = apply_mrope(q, q_pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, q_pos if q_pos.dim() == 2 else q_pos[0], cfg.rope_theta)
        k = apply_rope(k, positions if positions.dim() == 2 else positions[0], cfg.rope_theta)
    v = v.reshape(b, s, kv, hd)
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


def _chunked_attention(q, k, v, cfg: ArchConfig, spec: BlockSpec, chunk: int, offset: int = 0) -> Tensor:
    """Online softmax over the static list of causal chunk pairs (i, j <= i),
    as the reference scans it: each pair's scores are (B, H, chunk, chunk),
    and only the causal half of the pairs runs.  A local layer keeps the
    pairs whose chunk distance is within ``span`` of the window.  ``offset``
    (a multiple of ``chunk``): q holds rows [offset, offset + Q) of the
    sequence k and v cover from row 0 (a sequence-split query block)."""
    b, nq, h, hd = q.shape
    assert nq % chunk == 0 and offset % chunk == 0 and k.shape[1] % chunk == 0, (nq, offset, chunk)
    scale = _scale(cfg, hd)
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    nc, base = nq // chunk, offset // chunk
    pairs = np.array([(i, j) for i in range(nc) for j in range(base + i + 1)], np.int64).reshape(-1, 2)
    if spec.attn_type == "local":
        span = -(-cfg.window_size // chunk)  # chunks that can be in-window
        pairs = pairs[base + pairs[:, 0] - pairs[:, 1] <= span]
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
        gq = (offset + i * chunk + local)[:, None]
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


class _Heads(NamedTuple):
    """How a layer's heads lie on this rank (``_heads``)."""

    tp: bool  # wo split over "model" (row-parallel, its output all-reduced)
    m: int  # "model" ranks (1 without tp)
    idx: int  # this rank's index along "model"
    q_split: bool  # this rank computes its h / m q heads
    kv_split: bool  # and its kv / m kv heads
    hl: int  # q heads computed here
    kvl: int  # kv heads computed here
    weight: Callable[[str], Tensor]  # the leaf a product reads


def _heads(params, cfg: ArchConfig) -> _Heads:
    """On placed blocks (``parallel/fsdp_tp``) each weight is gathered over
    ``data``; with ``wo`` split over ``model`` a rank computes its q heads
    where whole q heads fall on each rank, and its kv heads where whole kv
    heads do too (a rank's q heads then read exactly its kv heads).  A leaf
    that does not split on a head boundary is gathered over ``model`` and
    computed whole.  A whole leaf passes through every gather."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    cd = cfg.compute_dtype
    model = fsdp_tp.MODEL
    tp = fsdp_tp.split_over(params["wo"], model)
    m = shd.axis_size(model) if tp else 1
    idx = shd.axis_index(model) if tp else 0
    q_split = tp and h % m == 0 and fsdp_tp.split_over(params["wq"], model)
    kv_split = q_split and kv % m == 0 and fsdp_tp.split_over(params["wk"], model)
    split = {"wq": q_split, "bq": q_split, "wk": kv_split, "bk": kv_split, "wv": kv_split, "bv": kv_split,
             "wo": tp}

    def weight(name):
        return fsdp_tp.gather(params[name], model=not split[name], repeated=not tp, tp=tp).to(cd)

    return _Heads(tp, m, idx, q_split, kv_split, h // m if q_split else h, kv // m if kv_split else kv, weight)


def _seq_block(cache_k: Tensor) -> Tuple[int, int]:
    """(model ranks, this rank's index) of a cache layer (B, L, KV, hd)
    split by sequence over ``model`` (``parallel/fsdp_tp.place_caches``);
    (1, 0) for a whole one."""
    if fsdp_tp.split_dim(cache_k, fsdp_tp.MODEL) != 1:
        return 1, 0
    return shd.axis_size(fsdp_tp.MODEL), shd.axis_index(fsdp_tp.MODEL)


def _write_prefill(cache, k: Tensor, v: Tensor, lay: _Heads) -> None:
    """Write a prompt's k / v (B, S, heads, hd) into rows [0, S) of the
    cache, in place.  A cache split by sequence over ``model`` takes this
    rank's rows [idx Lr, (idx + 1) Lr) of them, all kv heads (an all-to-all
    over ``model`` where the kv heads are split over it); a later rank's
    block past the prompt stays unwritten.  A whole cache on split kv heads
    takes every rank's heads."""
    ck, cv = cache["k"], cache["v"]
    ranks, idx = _seq_block(ck)
    rows = ck.shape[1]
    if lay.kv_split and ranks == 1 and lay.m > 1:
        (group,) = shd.axis_groups(fsdp_tp.MODEL)
        k, v = fsdp_tp.gather_dim(k, 2, group), fsdp_tp.gather_dim(v, 2, group)
    elif lay.kv_split:
        k, v = fsdp_tp.all_to_all_heads_to_seq(k, rows), fsdp_tp.all_to_all_heads_to_seq(v, rows)
    elif ranks > 1:
        k, v = k[:, idx * rows:(idx + 1) * rows], v[:, idx * rows:(idx + 1) * rows]
    n = k.shape[1]
    ck[:, :n] = k
    cv[:, :n] = v


def _scoring_attention(params, x: Tensor, cfg: ArchConfig, spec: BlockSpec, positions: Tensor,
                       cache: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """The forward over the full sequence (a prefill writes k / v into rows
    [0, S) of ``cache`` first, ``_write_prefill``).  On placed blocks
    (``parallel/fsdp_tp``: the 2-D train step, the placed serving steps)
    each rank computes the heads ``_heads`` gives it, with ``wo``
    row-parallel: whole q heads give whole outputs, of which the rank keeps
    the columns of its ``wo`` rows; whole kv heads are indexed by the
    rank's q heads.

    Where the heads do not split over ``model`` and ``cfg.seq_shard_attention``
    is set (the reference's sequence-split layout), a rank computes q for
    its block of ceil(S / m) query rows, every head, and k / v for every
    row; it attends from its row offset (causal, window and softcap as
    everywhere), so its scores are (B, H, ceil(S / m), S), and an
    all-to-all over ``model`` (``fsdp_tp.all_to_all_seq_to_cols``, the
    inverse one backward) turns its rows of every column into every row of
    its ``wo`` rows' columns."""
    h, hd = cfg.n_heads, cfg.hd
    lay = _heads(params, cfg)
    if lay.tp:
        x = fsdp_tp.enter_tp(x)
    b, s = x.shape[:2]
    seq_split = cfg.seq_shard_attention and lay.tp and not lay.q_split and lay.m > 1
    rows = -(-s // lay.m) if seq_split else s  # query rows a block
    lo = lay.idx * rows if seq_split else 0
    n = max(0, min(rows, s - lo))  # this rank's (0 past the end)
    q, k, v = _project_qkv(params, x, cfg, positions, weight=lay.weight, heads=(lay.hl, lay.kvl), q_rows=(lo, n))
    if cache is not None:
        _write_prefill(cache, k, v, lay)
    if lay.q_split and not lay.kv_split:
        # whole kv heads: the ones this rank's q heads read, one a q head
        sel = torch.div(lay.idx * lay.hl + torch.arange(lay.hl, device=q.device), h // cfg.n_kv_heads,
                        rounding_mode="floor")
        k, v = k.index_select(2, sel), v.index_select(2, sel)
    chunk = cfg.attn_chunk_size
    if s > cfg.attn_chunk_threshold and s % chunk == 0 and n > 0 and rows % chunk == 0:
        out = _chunked_attention(q, k, v, cfg, spec, chunk, offset=lo)
    elif seq_split:
        out = _offset_prefill_attention(q, k, v, lo, cfg, spec)
    else:
        out = _full_attention(q, k, v, cfg, spec)
    out = out.reshape(b, n, lay.hl * hd)
    if seq_split:
        out = fsdp_tp.all_to_all_seq_to_cols(out, s, rows)
    return _row_parallel_out(out, lay, h * hd)


def _row_parallel_out(out: Tensor, lay: _Heads, width: int) -> Tensor:
    """``out @ wo``: with ``wo`` split over ``model`` by rows, the columns
    of ``out`` (whole heads, ``width`` wide, or already this rank's) that
    meet this rank's rows, the product all-reduced over ``model``."""
    if lay.tp and out.shape[-1] == width:
        cols = width // lay.m
        out = out[..., lay.idx * cols:(lay.idx + 1) * cols]
    out = out @ lay.weight("wo")
    return fsdp_tp.exit_tp(out) if lay.tp else out


def _placed_decode(params, x: Tensor, cfg: ArchConfig, spec: BlockSpec, positions: Tensor, cache, cache_len):
    """Single-token decode on placed blocks and a dense cache split by
    sequence over ``model`` (flash-decoding).  The rank whose block holds
    row ``cache_len`` (per slot where it is (B,)) writes the new token's k
    / v, every kv head; each rank attends its rows for every q head (q
    all-gathered over ``model`` where the heads are split) with the
    paged-attention kernel on its block viewed as one page a slot (no
    copy; the plain version for CPU tensors), which also returns the
    block's log-sum-exp; the ranks' (out, LSE) are all-gathered and merged
    exactly (``fsdp_tp.merge_partials``), and the rank finishes with the
    columns of its ``wo`` rows.  Positions stay global."""
    h, hd = cfg.n_heads, cfg.hd
    lay = _heads(params, cfg)
    if lay.tp:
        x = fsdp_tp.enter_tp(x)
    q, k, v = _project_qkv(params, x, cfg, positions, weight=lay.weight, heads=(lay.hl, lay.kvl))
    if lay.m > 1 and (lay.q_split or lay.kv_split):
        (group,) = shd.axis_groups(fsdp_tp.MODEL)
        q = fsdp_tp.gather_dim(q, 2, group) if lay.q_split else q  # every q head
        if lay.kv_split:  # the new token's every kv head
            k, v = fsdp_tp.gather_dim(k, 2, group), fsdp_tp.gather_dim(v, 2, group)
    ck, cv = cache["k"], cache["v"]
    ranks, idx = _seq_block(ck)
    b, rows = ck.shape[:2]
    start = idx * rows
    kw, vw = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    if torch.is_tensor(cache_len):
        # per slot ((B,), or a 0-d tensor for every slot): no host read
        local = cache_len.long().reshape(-1).expand(b) - start
        own = ((local >= 0) & (local < rows))[:, None, None]
        lanes = torch.arange(b, device=x.device)
        at = local.clamp(0, rows - 1)
        # a slot whose row lies on another rank rewrites the row it reads
        ck[lanes, at] = torch.where(own, kw, ck[lanes, at])
        cv[lanes, at] = torch.where(own, vw, cv[lanes, at])
        lens = (local + (start + 1)).to(torch.int32)
    else:
        pos = int(cache_len)
        if start <= pos < start + rows:
            ck[:, pos - start] = kw
            cv[:, pos - start] = vw
        lens = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    tables = torch.arange(b, dtype=torch.int32, device=x.device)[:, None]
    res = paged_decode_attention(
        q[:, 0].float().contiguous(), ck, cv, tables, lens,
        scale=_scale(cfg, hd),
        softcap=cfg.attn_softcap or 0.0,
        window=cfg.window_size if spec.attn_type == "local" else 0,
        start=start, return_lse=ranks > 1,
    )
    if ranks > 1:
        out, lse = res
        out = fsdp_tp.merge_partials(fsdp_tp.gather_blocks(out), fsdp_tp.gather_blocks(lse))
    else:
        out = res
    out = out.to(q.dtype).reshape(b, 1, h * hd)
    return _row_parallel_out(out, lay, h * hd)


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
    also runs placed blocks (``parallel/fsdp_tp``: the 2-D train step, the
    placed prefill); a one-token decode on placed blocks or a placed dense
    cache takes ``_placed_decode``.
    """
    b, s, _ = x.shape
    if cache is None or (s > 1 and not chunked):
        return _scoring_attention(params, x, cfg, spec, positions, cache), cache
    placed = fsdp_tp.placement(params["wo"]) is not None
    if s == 1 and "k" in cache and (placed or fsdp_tp.placement(cache["k"]) is not None):
        return _placed_decode(params, x, cfg, spec, positions, cache, cache_len), cache
    if placed:
        raise ValueError("placed parameters serve from dense caches (prefill and one-token decode): "
                         "the paged and chunked paths take whole ones")
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
