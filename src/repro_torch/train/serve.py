"""Serving steps: prefill + decode factories, per-slot cache surgery and a
batched greedy generator (port of ``repro/train/serve.py``).

Continuous batching (``repro_torch.serve.engine.ContinuousLMEngine``) drives
the decode step with a *vector* ``cache_len`` — one position per slot — and
manages per-slot state with the surgery helpers below.

JAX's functional updates (``.at[].set`` under ``donate_argnums``) become in
place writes here: every helper mutates the pool it is given
(``index_put_`` / ``index_copy_`` / ``zero_``) and returns it, and the step
functions return the caches they were handed, written in place.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import forward, init_caches, is_paged, logits_from_hidden, vocab_start
from repro_torch.parallel import fsdp_tp
from repro_torch.parallel import sharding as shd

Tensor = torch.Tensor


def _placed_layout(params, caches):
    """(mesh, the axes a cache's slots split over or None) where ``params``
    or ``caches`` are placed blocks (``parallel/fsdp_tp.place_params`` /
    ``place_caches``), else None.  The slots' axes are any placed leaf's
    batch dimension: KV rows, Mamba or RWKV6 state."""
    mesh = fsdp_tp.tree_mesh(params) or fsdp_tp.tree_mesh(caches or {})
    if mesh is None:
        return None
    for leafs in (caches or {}).values():
        for leaf in leafs.values():  # every leaf is (stack, batch, ...): KV rows or recurrent state
            pl = fsdp_tp.placement(leaf)
            if pl is not None and len(pl.spec) > 1:
                return mesh, pl.spec[1]
    return mesh, None


@contextlib.contextmanager
def _serving(layout):
    """What a placed step runs under: no gradients, the blocks' mesh, and
    the slots' batch axes as the data-parallel axis (an MoE layer routes
    the whole batch, as GSPMD does the reference's global array)."""
    if layout is None:
        yield
        return
    mesh, axes = layout
    with torch.no_grad(), shd.sharding_context(mesh) if mesh is not shd.current_mesh() else contextlib.nullcontext():
        with shd.data_parallel(axes):
            yield


def _whole_vocab(params, cfg: ArchConfig, logits: Tensor) -> Tensor:
    """Logits of every vocabulary column: a placed head split over
    ``model`` gives this rank's columns of the flat (n_codebooks x)
    vocabulary, all-gathered here (audio: reshaped to (…, n_codebooks, V));
    a whole head's logits pass through."""
    if vocab_start(params, cfg) is None:
        return logits
    if shd.axis_size(fsdp_tp.MODEL) > 1:
        (group,) = shd.axis_groups(fsdp_tp.MODEL)
        logits = fsdp_tp.gather_dim(logits, logits.dim() - 1, group)
    if cfg.frontend == "audio_codes":
        logits = logits.reshape(*logits.shape[:-1], cfg.n_codebooks, cfg.vocab_size)
    return logits


def make_prefill_step(cfg: ArchConfig):
    """Prefill (B, S) prompts ((B, S, n_codebooks) codes for audio; or
    (B, S, d) ``embeds`` and M-RoPE ``positions`` for a vision frontend)
    from row 0; returns (last-row logits (B, 1, V), caches).  Only the last
    row goes through the LM head.

    On placed blocks (``parallel/fsdp_tp.place_params`` and
    ``place_caches``: the reference's 2-D serving layout, KV rows over
    ``model``, Mamba state's channels over ``model``, RWKV6 state whole on
    every ``model`` rank) each rank passes its block of the prompts (its
    slots of the caches' batch axes) and gets its slots' logits over the
    whole vocabulary; an MoE layer routes every rank's slots together."""

    def prefill(params, caches, tokens=None, impl=None, *, embeds=None, positions=None):
        layout = _placed_layout(params, caches)
        with _serving(layout):
            out = forward(params, cfg, tokens, positions=positions, caches=caches, cache_len=0, impl=impl,
                          head=False, embeds=embeds)
            return _whole_vocab(params, cfg, logits_from_hidden(params, cfg, out.hidden[:, -1:])), out.caches

    return prefill


def make_decode_step(cfg: ArchConfig, return_hidden: bool = False):
    """One-token decode step.  ``cache_len`` may be an int (whole-batch
    position, the ``greedy_generate`` regime) or a (B,) tensor of per-slot
    positions (continuous batching).  ``block_tables`` routes the paged
    attention path when the caches are page pools; ``impl`` picks its route
    (``models.attention.use_kernel``).  With ``return_hidden`` the step also
    yields the final hidden state of the new token — the decorrelation
    probe's sampling target for in-flight slots.  A vision frontend passes
    ``embeds`` (B, 1, d) and ``positions`` (3, B, 1).

    On placed blocks (see ``make_prefill_step``) each rank passes its slots'
    tokens and global ``cache_len``; every rank attends its rows of the
    dense caches and the ranks' partial softmaxes are merged
    (``models/attention._placed_decode``)."""

    def decode(params, caches, cache_len, tokens=None, block_tables=None, impl=None, *, embeds=None,
               positions=None):
        layout = _placed_layout(params, caches)
        with _serving(layout):
            out = forward(params, cfg, tokens, positions=positions, caches=caches, cache_len=cache_len,
                          block_tables=block_tables, impl=impl, embeds=embeds)
            logits = _whole_vocab(params, cfg, out.logits[:, 0])
        if return_hidden:
            return logits, out.hidden[:, 0], out.caches
        return logits, out.caches

    return decode


def make_verify_step(cfg: ArchConfig, return_hidden: bool = False):
    """Multi-token speculative verify — the decode step at a lane-batched
    shape.

    The verify scores a slot's ``k`` drafted tokens (plus the bonus
    position) by laying the ``k + 1`` positions out on the BATCH axis: lane
    ``j`` carries ``cache_len = pos + j``, input token ``last_token``
    (j = 0) or ``draft[j - 1]``, and the slot's (scratch-remapped) table
    row.  Every lane is then exactly a one-token paged decode, which is what
    keeps greedy speculative outputs equal to sequential decode.  The
    write-before-read inside ``_paged_decode`` makes lane ``j`` see the rows
    lanes ``< j`` just wrote (``pos .. pos + j - 1``, inside its
    ``cache_len`` window on the shared table row).

    The returned callable IS ``make_decode_step``'s: one contract, two
    batch shapes (``n_slots`` for the pool tick, ``n_slots * (k + 1)`` for
    the verify)."""
    return make_decode_step(cfg, return_hidden=return_hidden)


def make_prefill_at_step(cfg: ArchConfig):
    """Prefill a right-padded prompt and read the outputs at the TRUE last
    prompt token (``true_len - 1``), not the padded end.

    Causal attention never lets position ``true_len - 1`` see the padding
    rows, so the logits / hidden row are exactly the unpadded prefill's; the
    cache rows the padding wrote are masked by the slot's ``cache_len``
    during decode and overwritten as the slot advances.  Returns (logits
    (B, V), hidden (B, d), caches)."""

    def prefill_at(params, caches, tokens, true_len: int, impl=None):
        out = forward(params, cfg, tokens, caches=caches, cache_len=0, impl=impl, head=False)
        hidden = out.hidden[:, max(int(true_len) - 1, 0)]
        return logits_from_hidden(params, cfg, hidden), hidden, out.caches

    return prefill_at


def make_chunked_prefill_step(cfg: ArchConfig):
    """One chunk of an incremental prefill at batch 1: write the chunk's KV
    at rows [offset, offset + C), attend causally across the prefix already
    written AND within the chunk, and read logits / hidden at the chunk's
    true last token ``last`` (chunk-local; only meaningful on the final
    chunk — earlier chunks run for their cache writes).  Only that one row
    goes through the LM head.

    Chunks are a fixed C wide; only the final chunk may be right-padded
    (its pad rows write KV beyond the prompt, masked by ``cache_len`` during
    decode and overwritten as the slot advances).  Chunked prefill is
    argmax-stable against the whole-prompt prefill, not bitwise: the chunk
    boundary changes the shapes of the prefill's products.  Returns (logits
    (1, V), hidden (1, d), caches)."""

    def prefill_chunk(params, caches, tokens, offset: int, last: int, impl=None):
        out = forward(params, cfg, tokens, caches=caches, cache_len=int(offset), impl=impl, head=False,
                      chunked_prefill=True)
        hidden = out.hidden[:, int(last)]
        return logits_from_hidden(params, cfg, hidden), hidden, out.caches

    return prefill_chunk


# ---------------------------------------------------------------------------
# Per-slot cache pool surgery (continuous batching)
# ---------------------------------------------------------------------------
#
# Dense leaves are (repeats, batch, ...) — axis 1 is the slot axis; paged
# pools mix two layouts per pattern position: attention holds page pools
# (repeats, P, page, KV, hd) addressed through block tables, while Mamba /
# RWKV state stays slot-major (repeats, batch, ...) as in the dense pool.
# Every helper writes the pool in place and returns it.


def _index(idx, device) -> Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)


def insert_slot_state(pool, one, slot: int):
    """Copy a batch-1 cache / state tree ``one`` into slot ``slot`` of the
    dense pool (leaf shapes (repeats, 1, ...) -> (repeats, B, ...))."""
    for name, leafs in pool.items():
        for key, leaf in leafs.items():
            leaf[:, slot] = one[name][key][:, 0].to(leaf.dtype)
    return pool


def reset_slot_state(pool, slot: int):
    """Zero slot ``slot`` across every leaf (decode masks freed slots by
    ``cache_len`` anyway; zeroing keeps retired KV and recurrent state out
    of later reads and makes slot reuse order-independent)."""
    for leafs in pool.values():
        for leaf in leafs.values():
            leaf[:, slot].zero_()
    return pool


def insert_slot_state_paged(pool, one, slot: int, bt_row):
    """Scatter a prefilled batch-1 DENSE cache tree ``one`` into the paged
    pool: attention rows [j * page, (j + 1) * page) land in physical page
    ``bt_row[j]``, recurrent state is a dense write into slot ``slot``.
    Only the blocks the slot owns are written (the reference also writes its
    unassigned, sentinel entries, whose rows page 0 absorbs and no unmasked
    read ever sees).  ``bt_row``: (NB,) ints with NB * page == the
    template's max_len."""
    row = np.asarray(bt_row)
    blocks = np.nonzero(row)[0]
    for name, leafs in pool.items():
        if not is_paged(leafs):
            for key, leaf in leafs.items():
                leaf[:, slot] = one[name][key][:, 0].to(leaf.dtype)
            continue
        if not blocks.size:
            continue
        page = leafs["k_pages"].shape[2]
        dst = _index(row[blocks], leafs["k_pages"].device)
        src = _index(blocks, leafs["k_pages"].device)
        for key, dense in (("k_pages", "k"), ("v_pages", "v")):
            rows = one[name][dense][:, 0]  # (repeats, L, KV, hd), L == NB * page
            rows = rows.reshape(rows.shape[0], -1, page, *rows.shape[2:])
            leafs[key][:, dst] = rows[:, src].to(leafs[key].dtype)
    return pool


def reset_slot_state_paged(pool, slot: int, bt_row):
    """Zero a retired slot's pages and its dense recurrent state.  Sentinel
    entries of ``bt_row`` zero page 0 too, which is harmless (it is never
    read unmasked)."""
    for leafs in pool.values():
        if not is_paged(leafs):
            for leaf in leafs.values():
                leaf[:, slot].zero_()
            continue
        idx = _index(bt_row, leafs["k_pages"].device)
        for key in ("k_pages", "v_pages"):
            leafs[key][:, idx] = 0
    return pool


def load_template_from_pages(pool, one, bt_row):
    """Inverse of ``insert_slot_state_paged`` for one slot: gather physical
    pages ``bt_row`` of the paged pool into the batch-1 DENSE template
    ``one`` (template rows [j * page, (j + 1) * page) read page
    ``bt_row[j]``), in place.  A warm prefix-cache request seeds its
    chunked-prefill template this way, so the chunks attend over the shared
    prefix's exact KV rows without recomputing them.  Sentinel entries copy
    page 0's rows, which ``cache_len`` masks.  Recurrent leaves of ``one``
    stay as they are (prefix caching is attention-only)."""
    for name, leafs in pool.items():
        if not is_paged(leafs):
            continue
        idx = _index(bt_row, leafs["k_pages"].device)
        for key, dense in (("k_pages", "k"), ("v_pages", "v")):
            rows = leafs[key][:, idx]  # (repeats, NB, page, KV, hd)
            tpl = one[name][dense]
            tpl[:, 0] = rows.reshape(rows.shape[0], -1, *rows.shape[3:]).to(tpl.dtype)
    return one


def apply_page_moves(pool, src, dst):
    """Copy physical pages ``src[i] -> dst[i]`` across every paged leaf (the
    device half of allocator compaction); recurrent state never moves.
    Every source page is read before any destination is written — as the
    reference reads the old pool — so a chain of moves (a -> b, b -> c)
    never sees a page that already moved.  Identity moves (src == dst) are
    no-ops."""
    for leafs in pool.values():
        if not is_paged(leafs):
            continue
        s = _index(src, leafs["k_pages"].device)
        d = _index(dst, leafs["k_pages"].device)
        for key in ("k_pages", "v_pages"):
            moved = leafs[key][:, s]  # a gathered copy: all reads first
            leafs[key][:, d] = moved
    return pool


def greedy_generate(
    params,
    cfg: ArchConfig,
    prompt_tokens: Tensor,
    max_new_tokens: int,
    max_len: Optional[int] = None,
    steps: Optional[Tuple] = None,
) -> Tensor:
    """Host-loop batched greedy decoding.  ``prompt_tokens``: (B, S) ids, or
    (B, S, n_codebooks) codes for audio-code models, on the params' device;
    returns (B, max_new_tokens) int32 ids ((B, max_new_tokens, n_codebooks)
    for audio: each codebook's head argmaxed).  ``steps``: an optional
    ``(prefill, decode)`` pair (``LMServeEngine`` passes its own)."""
    b, s = prompt_tokens.shape[:2]
    max_len = max_len or (s + max_new_tokens)
    caches = init_caches(cfg, b, max_len, device=prompt_tokens.device)
    if steps is None:
        steps = (make_prefill_step(cfg), make_decode_step(cfg))
    prefill, decode = steps
    logits, caches = prefill(params, caches, prompt_tokens)
    toks = [torch.argmax(logits[:, 0], dim=-1).to(torch.int32)]
    for pos in range(s, s + max_new_tokens - 1):
        logits, caches = decode(params, caches, pos, toks[-1][:, None])
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
    return torch.stack(toks, dim=1)
