"""The serving engine: bucketed embedding forward passes (port of
``ServeEngine`` from ``repro/serve/engine.py``, single device).

``ServeEngine`` wraps the SSL encoder + projector (``repro_torch.train.ssl``)
behind the bucket ladder of ``repro_torch.serve.buckets``: inputs are
zero-padded to the request's bucket, the model runs eagerly under
``torch.no_grad``, and the padding is sliced off.  Rows are
independent through the MLP, so padding never leaks into real outputs.
``warmup`` runs every bucket once so no request pays a first-call cost.
Checkpoint loading, the mesh (data-parallel) and tp (feature-sharded)
forwards belong to later slices.

``LMServeEngine`` (whole-request greedy generation) and
``ContinuousLMEngine`` (the continuous-batching slot pool, dense or paged
KV cache) are the token-model counterparts.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels.utils import next_multiple
from repro_torch.models.common import check_supported
from repro_torch.models.transformer import init_caches
from repro_torch.serve.buckets import BucketPolicy, bucket_for, bucket_sizes
from repro_torch.serve.paging import PagedKVManager
from repro_torch.serve.slots import SlotPool
from repro_torch.train.serve import (
    apply_page_moves,
    greedy_generate,
    insert_slot_state,
    insert_slot_state_paged,
    make_decode_step,
    make_prefill_at_step,
    make_prefill_step,
    reset_slot_state,
    reset_slot_state_paged,
)
from repro_torch.train.ssl import SSLModel, SSLModelConfig

Tensor = torch.Tensor


class ServeEngine:
    """Embedding forward over a bounded ladder of batch shapes."""

    def __init__(
        self,
        model_cfg: SSLModelConfig,
        model: SSLModel,
        *,
        policy: BucketPolicy = BucketPolicy(),
        device: DeviceLike = None,
    ):
        self.model_cfg = model_cfg
        self.policy = policy.validate()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._warm: Set[int] = set()

    @property
    def d(self) -> int:
        """Embedding width (the projector's output dimension)."""
        return int(self.model_cfg.projector_widths[-1])

    def warmup(self) -> Tuple[int, ...]:
        """Run every bucket once (zeros in), so no request pays a first call."""
        for b in bucket_sizes(self.policy):
            x = torch.zeros((b, self.model_cfg.input_dim), dtype=torch.float32, device=self.device)
            with torch.no_grad():
                self.model(x)
            self._warm.add(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return bucket_sizes(self.policy)

    def compiled_buckets(self) -> Tuple[int, ...]:
        """Batch sizes that have run at least once, ascending."""
        return tuple(sorted(self._warm))

    def encode(self, x) -> Tensor:
        """(n, input_dim) -> (n, d) on the engine's device: pad to the
        bucket, run, strip the padding.  Returns without synchronising."""
        if not isinstance(x, Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32))
        x = x.to(device=self.device, dtype=torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        n = x.shape[0]
        top = bucket_sizes(self.policy)[-1]
        if n > top:
            # coalescing can overshoot max_batch by one multi-row request
            # (and the naive bench feeds arbitrary n): chunk at the largest
            # bucket so every forward stays within the warmed ladder
            return torch.cat([self.encode(x[i : i + top]) for i in range(0, n, top)], dim=0)
        b = bucket_for(n, self.policy)
        if n < b:
            pad = torch.zeros((b - n, x.shape[1]), dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=0)
        with torch.no_grad():
            z = self.model(x)
        self._warm.add(b)
        return z[:n]



# ---------------------------------------------------------------------------
# Token-model serving
# ---------------------------------------------------------------------------


def _check_on(device: torch.device, **tensors: Tensor) -> None:
    """Raise unless every named tensor lies on ``device`` (no silent move)."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} lie on {t.device}, the engine runs on {device}")


class LMServeEngine:
    """Whole-request greedy generation with one (prefill, decode) step pair
    shared across requests (port of ``LMServeEngine``)."""

    def __init__(self, arch_cfg, device: DeviceLike = None):
        self.cfg = arch_cfg
        self.device = resolve_device(device)
        self.steps = (make_prefill_step(arch_cfg), make_decode_step(arch_cfg))

    def generate(self, params, prompt_tokens: Tensor, max_new_tokens: int, max_len=None) -> Tensor:
        """(B, S) prompts -> (B, max_new_tokens) ids; params and prompts must
        lie on the engine's device."""
        _check_on(self.device, params=params["embed"], prompt_tokens=prompt_tokens)
        return greedy_generate(params, self.cfg, prompt_tokens, max_new_tokens, max_len=max_len, steps=self.steps)


# page size of the paged pool when the caller names none: the reference
# CLI's --block-size fallback (the tuned pick waits for the port's tuner)
DEFAULT_PAGE = 16


class ContinuousLMEngine:
    """Continuous-batching LM engine over a fixed pool of decode slots (port
    of ``ContinuousLMEngine``: dense and paged modes, greedy).

    The pool's N slots all advance one token per ``decode_step`` — with a
    per-slot ``cache_len`` — and a freed slot admits the next queued request
    on the very next step via ``insert`` (prefill the prompt at batch 1 into
    a template, then copy its KV rows into the slot's cache rows or pages).
    Prompts are right-padded to a geometric length ladder
    (``prompt_bucket_sizes``); causality keeps the padding out of every real
    row.  The decode step also returns each slot's final hidden state, which
    the service samples for the decorrelation probe.

    ``paged=True`` replaces the per-slot dense rows with fixed-size token
    pages addressed through block tables (``repro_torch.serve.paging``):
    admission reserves pages OOM-safely, decode writes and reads through the
    tables — on a CUDA pool with the hand-written paged-attention kernel —
    and retirement zeroes the slot's pages, returns them and compacts the
    pool.  ``max_len`` is rounded up to a page multiple so NB * page equals
    the dense extent: the plain (gather) route is then bit-identical to the
    dense engine.

    ``impl`` picks the paged attention route (``None``: the kernel on CUDA,
    the gather route on the CPU; ``"plain"``: the gather route everywhere).
    The engine runs on ``device`` (``cuda`` unless ``"cpu"`` is passed) and
    raises if ``params`` lie elsewhere.  Chunked prefill, sampling, the
    prefix cache and speculative decoding are options of the same engine
    that slice 3b of the port brings; until then they are not parameters.
    """

    def __init__(
        self,
        arch_cfg,
        params,
        *,
        n_slots: int = 8,
        max_len: int = 128,
        max_prompt_len: Optional[int] = None,
        prompt_align: int = 8,
        paged: bool = False,
        page_size: Optional[int] = None,
        total_pages: Optional[int] = None,
        impl: Optional[str] = None,
        device: DeviceLike = None,
    ):
        check_supported(arch_cfg)
        self.device = resolve_device(device)
        _check_on(self.device, params=params["embed"])
        self.cfg = arch_cfg
        self.params = params
        self.impl = impl
        self.paged = bool(paged)
        self.pager = None
        if self.paged:
            page = int(page_size or DEFAULT_PAGE)
            if page < 1:
                raise ValueError(f"page_size must be >= 1, got {page}")
            max_len = next_multiple(max_len, page)
            self.pager = PagedKVManager(arch_cfg, n_slots, max_len, page, total_pages=total_pages)
        self.pool = SlotPool(n_slots, max_len)
        max_prompt = int(max_prompt_len or max(max_len // 2, prompt_align))
        if max_prompt >= max_len:
            raise ValueError(f"max_prompt_len={max_prompt} must leave decode room (< max_len={max_len})")
        self._prompt_policy = BucketPolicy(max_batch=max_prompt, align=prompt_align, max_wait_ms=0.0)
        if bucket_sizes(self._prompt_policy)[-1] > max_len:
            raise ValueError(
                f"padded prompt bucket {bucket_sizes(self._prompt_policy)[-1]} "
                f"(max_prompt_len={max_prompt} rounded up to align={prompt_align}) "
                f"exceeds max_len={max_len}; lower max_prompt_len or raise max_len"
            )
        self.caches = (
            self.pager.init_caches(self.device) if self.paged
            else init_caches(arch_cfg, n_slots, max_len, self.device)
        )
        # batch-1 prefill template, written in place by every insert: rows
        # past a prompt keep an earlier prompt's values, which the slot's
        # cache_len masks exactly as the reference masks its padding rows
        self._caches1 = init_caches(arch_cfg, 1, max_len, self.device)
        self._decode = make_decode_step(arch_cfg, return_hidden=True)
        self._prefill = make_prefill_at_step(arch_cfg)

    # -- admission-side shape policy ----------------------------------------

    def prompt_bucket_sizes(self) -> Tuple[int, ...]:
        """Prompt-padding bucket ladder, ascending."""
        return bucket_sizes(self._prompt_policy)

    @property
    def max_prompt_len(self) -> int:
        """Largest admissible prompt length (the top bucket)."""
        return self.prompt_bucket_sizes()[-1]

    def validate_request(self, prompt_len: int, max_new_tokens: int):
        """Submit-time check: reject (never hang) what cannot be scheduled —
        empty prompts, prompts beyond the largest bucket, requests whose rows
        overflow the slot's cache or (paged) an empty pool's pages."""
        if prompt_len < 1:
            raise ValueError("empty prompt: prompt_len must be >= 1")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt_len > self.max_prompt_len:
            raise ValueError(
                f"prompt_len={prompt_len} exceeds the largest prompt bucket "
                f"({self.max_prompt_len}); rejecting instead of queueing unservable work"
            )
        rows = prompt_len + max_new_tokens - 1
        if rows > self.pool.max_len:
            raise ValueError(
                f"prompt_len + max_new_tokens - 1 = {rows} exceeds the slot cache ({self.pool.max_len} rows)"
            )
        if self.paged and not self.pager.fits_ever(prompt_len, max_new_tokens):
            raise ValueError(
                f"request needs {self.pager.alloc.pages_for_tokens(rows)} pages "
                f"> the pool's {self.pager.alloc.usable_pages} usable pages"
            )

    def can_admit(self, request) -> bool:
        """Beyond a free slot, a paged pool needs the request's worst-case
        page reservation to fit now (deferred, not rejected, otherwise)."""
        return not self.paged or self.pager.can_admit(request.prompt_len, request.max_new_tokens)

    # -- warmup --------------------------------------------------------------

    @torch.no_grad()
    def warmup(self) -> Tuple[int, ...]:
        """Run every prompt bucket's prefill and the pool decode step once
        (this builds the CUDA kernels), so no admitted request pays a first
        call.  The decode writes row 0 of every slot (dense) or of the
        sentinel page (paged): an insert overwrites the former, nothing
        reads the latter unmasked."""
        buckets = self.prompt_bucket_sizes()
        for length in buckets:
            toks = torch.zeros((1, length), dtype=torch.int32, device=self.device)
            self._prefill(self.params, self._caches1, toks, 1)
        n = self.pool.n_slots
        zeros = torch.zeros((n,), dtype=torch.int32, device=self.device)
        bt = None
        if self.paged:
            bt = torch.zeros((n, self.pager.blocks_per_slot), dtype=torch.int32, device=self.device)
        self.step_logits(self.caches, zeros, zeros, bt, self.impl)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return buckets

    # -- slot mechanics ------------------------------------------------------

    def admit_slot(self, slot) -> None:
        """Post-``pool.admit`` hook: charge the paged reservation."""
        if self.paged:
            self.pager.admit(slot.index, slot.request.prompt_len, slot.request.max_new_tokens)

    @torch.no_grad()
    def insert(self, slot) -> Tuple[int, Tensor]:
        """Prefill an admitted request and copy its KV rows into the slot.
        Returns (first token id, its hidden row (1, d_model) on the device):
        the prefill emits the request's first token (the TTFT point)."""
        req = slot.request
        n = req.prompt_len
        length = bucket_for(n, self._prompt_policy)
        padded = np.zeros((1, length), np.int32)
        padded[0, :n] = np.asarray(req.tokens, np.int32)
        logits, hidden, one = self._prefill(
            self.params, self._caches1, torch.as_tensor(padded, device=self.device), n
        )
        if self.paged:
            self.pager.ensure_rows(slot.index, n)
            insert_slot_state_paged(self.caches, one, self.pager.table_row(slot.index))
        else:
            insert_slot_state(self.caches, one, slot.index)
        first = int(torch.argmax(logits[0]))  # a host sync
        return first, hidden

    def step_logits(self, caches, lens: Tensor, tokens: Tensor, block_tables: Optional[Tensor], impl=None):
        """The model's decode step over the pool: (logits (N, V) f32, hidden
        (N, d), caches written in place).  ``decode_step`` drives it; a
        checking harness may run it on a copy of the caches with another
        ``impl``."""
        return self._decode(self.params, caches, lens, tokens[:, None], block_tables=block_tables, impl=impl)

    @torch.no_grad()
    def decode_step(self) -> Tuple[np.ndarray, Tensor]:
        """One batched decode over the whole pool.  Returns (next token per
        slot (N,) int32 on the host, hidden rows (N, d_model) on the
        device); free-slot lanes are garbage the caller masks by
        ``pool.active_indices()``."""
        pool = self.pool
        lens = torch.as_tensor(pool.cache_lens(), device=self.device)
        toks = torch.as_tensor(pool.last_tokens(), device=self.device)
        bt = None
        if self.paged:
            for i in pool.active_indices():
                # lazy page growth for the row this step writes (cannot fail:
                # admission reserved the worst case)
                self.pager.ensure_rows(i, pool[i].pos + 1)
            bt = torch.as_tensor(self.pager.block_tables(), device=self.device)
        logits, hidden, self.caches = self.step_logits(self.caches, lens, toks, bt, self.impl)
        out = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()  # host sync
        return out, hidden

    def abort_slot(self, index: int):
        """Host-only cleanup for a slot whose device step failed: hand back
        its pages and reservation (no device ops — the device may be wedged)."""
        if self.paged:
            self.pager.release(index)

    @torch.no_grad()
    def release(self, index: int):
        """Retire a slot: zero its cache rows or pages (hygiene; decode masks
        them), return its pages and reservation, and compact the page pool
        (copy-on-retire: the highest in-use pages move into the freed low
        holes)."""
        if not self.paged:
            reset_slot_state(self.caches, index)
            return
        reset_slot_state_paged(self.caches, self.pager.table_row(index))
        self.pager.release(index)
        src, dst = self.pager.plan_compaction()
        if src.size:
            apply_page_moves(self.caches, src, dst)
