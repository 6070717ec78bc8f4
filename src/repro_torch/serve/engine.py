"""The serving engine: bucketed embedding forward passes (port of
``ServeEngine`` from ``repro/serve/engine.py``).

``ServeEngine`` wraps the SSL encoder + projector (``repro_torch.train.ssl``)
behind the bucket ladder of ``repro_torch.serve.buckets``: inputs are
zero-padded to the request's bucket, the model runs eagerly under
``torch.no_grad``, and the padding is sliced off.  Rows are
independent through the MLP, so padding never leaks into real outputs.
``warmup`` runs every bucket once so no request pays a first-call cost.
``from_checkpoint`` serves what the training loop saved.

Under a ``DeviceMesh`` (``mesh=``) every rank of the mesh calls ``encode``
with the same rows, as every device of the reference's ``shard_map`` sees
the same global array: the forward is data-parallel (each rank embeds its
block of the bucket's rows over ``data_axis``, parameters replicated) and
the blocks are all-gathered back, so every rank returns the full (n, d) in
request order.  ``model_axis`` adds the tp forward: the projector's output
layer is column-sharded over that axis (each rank computes its (n/dp, d/mp)
feature block), and ``decorr/modes.all_to_all_features`` turns the blocks
into full-width rows sharded over (data, model).  The last projector layer
is affine, so the column-sharded forward computes the same products as the
unsharded one.

``LMServeEngine`` (whole-request greedy generation) and
``ContinuousLMEngine`` (the continuous-batching slot pool, dense or paged
KV cache, with chunked prefill, sampling, the prefix cache and speculative
decoding) are the token-model counterparts.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.decorr.modes import all_to_all_features
from repro_torch.kernels.paged_attention.ops import auto_page_size
from repro_torch.kernels.utils import next_multiple
from repro_torch.models.transformer import init_caches
from repro_torch.parallel import sharding as shd
from repro_torch.serve.buckets import BucketPolicy, bucket_for, bucket_sizes
from repro_torch.serve.paging import PagedKVManager, PrefixPlan
from repro_torch.serve.slots import SlotPool
from repro_torch.serve.spec import SlotDraft, SpecConfig
from repro_torch.train.serve import (
    apply_page_moves,
    greedy_generate,
    insert_slot_state,
    insert_slot_state_paged,
    load_template_from_pages,
    make_chunked_prefill_step,
    make_decode_step,
    make_prefill_at_step,
    make_prefill_step,
    reset_slot_state,
    reset_slot_state_paged,
)
from repro_torch.train.ssl import SSLModel, SSLModelConfig

Tensor = torch.Tensor


def _axis_size(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh axis {axis!r} is not on the mesh (axes {names})")
    return int(mesh.shape[names.index(axis)])


class ServeEngine:
    """Embedding forward over a bounded ladder of batch shapes."""

    def __init__(
        self,
        model_cfg: SSLModelConfig,
        model: SSLModel,
        *,
        policy: BucketPolicy = BucketPolicy(),
        mesh=None,
        data_axis: str = "data",
        model_axis: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.model_cfg = model_cfg
        self.policy = policy.validate()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        if model_axis is not None and mesh is None:
            raise ValueError("model_axis (tp mode) needs a mesh carrying that axis")
        self._rows_spec = None
        if mesh is not None:
            dp = _axis_size(mesh, data_axis)
            mp = _axis_size(mesh, model_axis) if model_axis is not None else 1
            if policy.align % (dp * mp):
                # tp buckets split over BOTH axes: the all-to-all turns
                # (n/dp, d/mp) blocks into (n/(dp*mp), d) rows
                raise ValueError(
                    f"BucketPolicy.align={policy.align} must be a multiple of the "
                    f"mesh extent ({dp}x{mp}={dp * mp}) so every bucket shards evenly"
                )
            if model_axis is not None:
                if self.d % mp:
                    raise ValueError(
                        f"embedding width d={self.d} must split evenly over the {model_axis!r} axis ({mp} devices)"
                    )
                model = self._tp_local(model, mesh, model_axis)
            self._in_spec = ((data_axis,), None)
            self._rows_spec = (((data_axis, model_axis) if model_axis is not None else (data_axis,)), None)
        self.model = model.to(self.device).eval()
        self._warm: Set[int] = set()
        # per-executable timing (repro_torch.obs.ExecTimer); services attach
        # obs.perf (None keeps encode() asynchronous)
        self.perf = None

    @staticmethod
    def _tp_local(model: SSLModel, mesh, model_axis: str) -> SSLModel:
        """This rank's model for the tp forward: the projector's output
        layer cut to this rank's block of d / mp rows (an ``nn.Linear``
        weight is (out, in)), everything else replicated."""
        last = len(model.projector) - 1
        state = dict(model.state_dict())
        for name in (f"projector.{last}.weight", f"projector.{last}.bias"):
            x = state[name]
            state[name] = shd.NamedSharding(mesh, ((model_axis,),) + (None,) * (x.dim() - 1)).local(x)
        widths = tuple(model.cfg.projector_widths[:-1]) + (int(state[f"projector.{last}.bias"].numel()),)
        local = SSLModel(dataclasses.replace(model.cfg, projector_widths=widths))
        local.load_state_dict(state)
        return local

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_dir: str,
        model_cfg: SSLModelConfig,
        *,
        step: Optional[int] = None,
        **kw,
    ) -> "ServeEngine":
        """Load the encoder + projector saved by the training loop.

        Training checkpoints a ``TrainState`` whose parameters lie under the
        ``params`` key; a bare parameter tree (``SSLModel.state_dict()``) is
        taken too.  ``step=None`` takes the newest committed step.  ``kw``
        goes to the constructor (``policy``, ``mesh``, ``model_axis``,
        ``device``): a checkpoint holds the full tree, so it serves on any
        mesh.
        """
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
        model = SSLModel(model_cfg)
        template = model.state_dict()
        try:
            params = restore_checkpoint(ckpt_dir, step, template)
        except KeyError:
            # the TrainState layout: restore the params subtree alone
            params = restore_checkpoint(ckpt_dir, step, {"params": template})["params"]
        model.load_state_dict(params)
        return cls(model_cfg, model, **kw)

    @property
    def d(self) -> int:
        """Embedding width (the projector's output dimension)."""
        return int(self.model_cfg.projector_widths[-1])

    @torch.no_grad()
    def _forward(self, x: Tensor, model=None) -> Tensor:
        """One bucket's rows -> (b, d): the model, or under a mesh this
        rank's block, the tp all-to-all and the gather of every block.
        ``model``: another copy of the engine's model (an analysis's fake
        copy); the engine's own by default."""
        model = self.model if model is None else model
        if self.mesh is None:
            return model(x)
        with shd.sharding_context(self.mesh):
            z = model(shd.NamedSharding(self.mesh, self._in_spec).local(x))
            if self.model_axis is not None:
                z = all_to_all_features(z.contiguous(), self.model_axis)
            return shd.NamedSharding(self.mesh, self._rows_spec).gather(z)

    def warmup(self) -> Tuple[int, ...]:
        """Run every bucket once (zeros in), so no request pays a first call
        (timed as each bucket's first-call gauge when a timer is attached,
        which then also gets each bucket's roofline join: ``embed_b{b}``)."""
        for b in bucket_sizes(self.policy):
            x = torch.zeros((b, self.model_cfg.input_dim), dtype=torch.float32, device=self.device)
            perf = self.perf
            t0 = perf.start() if perf is not None else 0.0
            self._forward(x)
            if perf is not None:
                perf.block(self.device)
                perf.record_compile(f"embed_b{b}", perf.elapsed(t0))
                # the roofline join, analysed on fake copies of the model
                perf.attach_jit(f"embed_b{b}", lambda model, x: self._forward(x, model), self.model, x)
            self._warm.add(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return bucket_sizes(self.policy)

    def compiled_buckets(self) -> Tuple[int, ...]:
        """Batch sizes that have run at least once, ascending."""
        return tuple(sorted(self._warm))

    def encode(self, x) -> Tensor:
        """(n, input_dim) -> (n, d) on the engine's device: pad to the
        bucket, run, strip the padding.  Returns without synchronising
        unless a timer is attached (then the time covers the device work)."""
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
        perf = self.perf
        if perf is not None:
            if b in self._warm:
                perf.cache_hit(f"embed_b{b}")
            else:
                perf.cache_miss(f"embed_b{b}")
            t0 = perf.start()
        z = self._forward(x)
        self._warm.add(b)
        if perf is not None:
            perf.block(self.device)
            perf.observe(f"embed_b{b}", perf.elapsed(t0))
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


class ContinuousLMEngine:
    """Continuous-batching LM engine over a fixed pool of decode slots (port
    of ``ContinuousLMEngine``).

    The pool's N slots all advance one token per ``decode_step`` — with a
    per-slot ``cache_len`` — and a freed slot admits the next queued request
    on the very next step via ``insert`` (prefill the prompt at batch 1 into
    a template, then copy its KV rows into the slot's cache rows or pages).
    Prompts are right-padded to a geometric length ladder
    (``prompt_bucket_sizes``); causality keeps the padding out of every real
    row.  A pattern with Mamba or RWKV positions would fold padding into its
    recurrent state, so it prefills at the exact prompt length
    (``pad_prompts`` False) and refuses chunked prefill and speculation;
    audio-code models ((B, S, n_codebooks) tokens) are refused and go
    through ``LMServeEngine.generate``.  The decode step also returns each
    slot's final hidden state, which the service samples for the
    decorrelation probe.

    Options (each off by default, leaving the dense greedy path as it is):

      * ``paged=True`` — fixed-size token pages addressed through block
        tables (``repro_torch.serve.paging``): admission reserves pages
        OOM-safely, decode writes and reads through the tables — on a CUDA
        pool with the hand-written paged-attention kernel — and retirement
        zeroes the slot's pages, returns them and compacts the pool.
        ``page_size=None`` takes ``auto_page_size`` for the pool's shape.
        ``max_len`` is rounded up to a page multiple so NB * page equals the
        dense extent: the plain (gather) route is then bit-identical to the
        dense engine.
      * ``prefill_chunk=N`` (paged) — prompts longer than N prefill N tokens
        per service tick into a batch-1 template, interleaved with pool
        decode, so a long prompt no longer stalls the in-flight slots; the
        finished prompt is scattered into its pages like any other insert.
        ``chunk_all`` sends every prompt through the chunk step.
      * ``sampling=True`` — prefill and decode return the f32 LOGITS rows
        (moved to the host) instead of the device argmax; the service draws
        tokens per request (``serve.sampling``: temperature / top-k,
        per-request numpy stream; temperature 0 stays exact greedy).
      * ``prefix_cache=True`` (paged) — retired prompts donate their full KV
        pages to a radix tree (``serve.paging.radix``); a warm request binds
        the matched pages into its block table read-only (refcounted; the
        reservation charges only the unshared tail), copies the boundary
        page on write when the hit ends mid-page, and resumes chunked
        prefill at the hit.  Forces ``chunk_all`` (and ``prefill_chunk =
        page`` when none is given): warm and cold prompts run the same chunk
        steps on the same chunk grid, which keeps warm tokens identical to
        unshared paging.
      * ``speculative=True`` (paged, greedy) — each tick a per-slot n-gram
        drafter (``serve.spec``) proposes up to ``draft_k`` tokens and ONE
        lane-batched verify (the decode step at batch ``n_slots * (draft_k
        + 1)``) scores every draft position; the longest draft prefix that
        matches the model's own argmax is accepted.  Speculative writes land
        on pinned scratch pages (``PagedKVManager.spec_begin``), so a
        rejected draft leaves no trace; an accepted span commits by swapping
        scratch pages into the block table.

    ``impl`` picks the paged attention route (``None``: the kernel on CUDA,
    the gather route on the CPU; ``"plain"``: the gather route everywhere).
    The engine runs on ``device`` (``cuda`` unless ``"cpu"`` is passed) and
    raises if ``params`` lie elsewhere.
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
        prefill_chunk: Optional[int] = None,
        sampling: bool = False,
        prefix_cache: bool = False,
        chunk_all: bool = False,
        speculative: bool = False,
        draft_k: int = 4,
        spec_ngram_max: int = 3,
        spec_ngram_min: int = 1,
        impl: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if arch_cfg.frontend == "audio_codes":
            raise NotImplementedError(
                "continuous batching serves flat token streams; audio-code "
                "models ((B, S, n_q) tokens) go through LMServeEngine.generate"
            )
        self.device = resolve_device(device)
        _check_on(self.device, params=params["embed"])
        self.cfg = arch_cfg
        self.params = params
        self.impl = impl
        self.sampling_enabled = bool(sampling)
        # right-padded prompt buckets only where causality hides the padding
        self.pad_prompts = all(spec.mixer == "attn" for spec in arch_cfg.pattern)
        self.paged = bool(paged)
        self.prefix_cache = bool(prefix_cache)
        # every prompt runs the chunk step; prefix caching forces it (a warm
        # resume must land on the grid the cold run used, or tokens drift)
        self.chunk_all = bool(chunk_all) or self.prefix_cache
        if self.prefix_cache and not self.paged:
            raise ValueError("prefix_cache shares KV pages; pass paged=True")
        self.speculative = bool(speculative)
        self.spec_cfg = None
        if self.speculative:
            if not self.paged:
                raise ValueError("speculative decoding verifies through scratch pages; pass paged=True")
            if self.sampling_enabled:
                raise ValueError(
                    "speculative decoding is greedy-only: acceptance compares the "
                    "draft against argmax outputs (sampling would need rejection "
                    "sampling over the verify logits)"
                )
            if not self.pad_prompts:
                raise ValueError(
                    "speculative decoding needs attention-only patterns: SSM/RWKV "
                    "per-slot state cannot advance k+1 positions independently in "
                    "one forward"
                )
            self.spec_cfg = SpecConfig(draft_k=int(draft_k), ngram_max=int(spec_ngram_max),
                                       ngram_min=int(spec_ngram_min))
        self.pager = None
        if self.paged:
            # the tuned page of this pool's shape when none is named
            page = int(page_size or auto_page_size(n_slots, max_len, arch_cfg.n_kv_heads, arch_cfg.hd))
            if page < 1:
                raise ValueError(f"page_size must be >= 1, got {page}")
            max_len = next_multiple(max_len, page)
            if self.prefix_cache and not prefill_chunk:
                prefill_chunk = page  # hit grid == page grid: COW only on the cap
            self.pager = PagedKVManager(
                arch_cfg, n_slots, max_len, page, total_pages=total_pages,
                prefix_cache=self.prefix_cache,
                prefix_chunk=int(prefill_chunk) if self.prefix_cache else None,
                spec_draft_k=self.spec_cfg.draft_k if self.speculative else 0,
            )
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.chunk_all and self.prefill_chunk is None:
            raise ValueError("chunk_all rides chunked prefill; pass prefill_chunk (paged)")
        if self.prefill_chunk is not None:
            if not self.paged:
                raise ValueError("prefill_chunk rides the paged machinery; pass paged=True")
            if not self.pad_prompts:
                raise ValueError(
                    "chunked prefill needs attention-only patterns (recurrent "
                    "mixers fold chunk padding into their state)"
                )
            if self.prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.pool = SlotPool(n_slots, max_len)
        max_prompt = int(max_prompt_len or max(max_len // 2, prompt_align))
        if max_prompt >= max_len:
            raise ValueError(f"max_prompt_len={max_prompt} must leave decode room (< max_len={max_len})")
        self._prompt_policy = BucketPolicy(max_batch=max_prompt, align=prompt_align, max_wait_ms=0.0)
        if self.pad_prompts and bucket_sizes(self._prompt_policy)[-1] > max_len:
            raise ValueError(
                f"padded prompt bucket {bucket_sizes(self._prompt_policy)[-1]} "
                f"(max_prompt_len={max_prompt} rounded up to align={prompt_align}) "
                f"exceeds max_len={max_len}; lower max_prompt_len or raise max_len"
            )
        if self.prefill_chunk is not None:
            tail = next_multiple(max_prompt, self.prefill_chunk)
            if tail > max_len:
                raise ValueError(
                    f"chunked prefill of a max_prompt_len={max_prompt} prompt pads "
                    f"to {tail} template rows > max_len={max_len}; shrink prefill_chunk"
                )
        self.caches = (
            self.pager.init_caches(self.device) if self.paged
            else init_caches(arch_cfg, n_slots, max_len, self.device)
        )
        # batch-1 prefill template, written in place by every insert: rows
        # past a prompt keep an earlier prompt's values, which the slot's
        # cache_len masks exactly as the reference masks its padding rows;
        # its recurrent state is zeroed before each prefill (the reference's
        # template is never written)
        self._caches1 = init_caches(arch_cfg, 1, max_len, self.device)
        # one step for the pool tick (B = n_slots) and the speculative verify
        # (B = n_slots * (draft_k + 1)): make_verify_step is this decode step
        self._decode = make_decode_step(arch_cfg, return_hidden=True)
        self._prefill = make_prefill_at_step(arch_cfg)
        # chunked prefill: ONE in-progress (slot index, batch-1 work tree) at
        # a time — chunks of different prompts serialize, decode interleaves.
        # The work tree is a template of its own: a whole-prompt insert in a
        # later tick must not overwrite a prompt still streaming in.
        self._chunk_live: Optional[int] = None
        self._chunk_tree = None
        if self.prefill_chunk is not None:
            self._chunk_tree = init_caches(arch_cfg, 1, max_len, self.device)
            self._chunk_step = make_chunked_prefill_step(arch_cfg)
        # one-deep plan memo from can_admit to admit_slot (same tick, same
        # head-of-line request — no allocation happens in between)
        self._plan_stash: Tuple[Optional[int], Optional[PrefixPlan]] = (None, None)
        # optional flight recorder (repro_torch.obs.FlightRecorder); the
        # service attaches its own, so page-table churn lands in the same
        # ring buffer as the scheduler's admit / retire events
        self.recorder = None
        # per-executable timing (repro_torch.obs.ExecTimer); the service
        # attaches obs.perf when telemetry is enabled
        self.perf = None
        self._warmed_prefill: set = set()

    # -- admission-side shape policy ----------------------------------------

    def prompt_bucket_sizes(self) -> Tuple[int, ...]:
        """Prompt-padding bucket ladder, ascending."""
        return bucket_sizes(self._prompt_policy)

    @property
    def max_prompt_len(self) -> int:
        """Largest admissible prompt length (the top bucket)."""
        return self.prompt_bucket_sizes()[-1]

    def _prompt_bucket(self, n: int) -> int:
        return bucket_for(n, self._prompt_policy) if self.pad_prompts else n

    def _prefill_template(self):
        """The batch-1 prefill template, its recurrent state zeroed."""
        for pos, spec in enumerate(self.cfg.pattern):
            if spec.mixer != "attn":
                for leaf in self._caches1[f"pos{pos}"].values():
                    leaf.zero_()
        return self._caches1

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
        (unshared) page reservation to fit now (deferred, not rejected,
        otherwise)."""
        if not self.paged:
            return True
        if self.prefix_cache:
            plan = self.pager.plan_prefix(request.tokens, request.prompt_len)
            self._plan_stash = (id(request), plan)
            return self.pager.can_admit(request.prompt_len, request.max_new_tokens, plan=plan)
        return self.pager.can_admit(request.prompt_len, request.max_new_tokens)

    # -- warmup --------------------------------------------------------------

    @torch.no_grad()
    def warmup(self, prompt_lens=None) -> Tuple[int, ...]:
        """Run every prompt bucket's prefill, the pool decode step and (with
        the options) the chunk step and the verify step once (this builds
        the CUDA kernels), so no admitted request pays a first call.
        Attention-only patterns run the whole padded ladder; recurrent ones
        prefill at exact lengths, so they run ``prompt_lens`` (the distinct
        lengths a caller expects; length 1 when none is given).  The decode
        and verify write row 0 of every slot (dense) or of the sentinel page
        (paged) and advance every slot's recurrent state: an insert
        overwrites a slot, nothing reads the sentinel unmasked, and slot 0
        is zeroed afterwards, as the reference leaves it.  With a timer,
        each executable's first call is its first-call gauge, and after it
        its roofline join is analysed on fake copies of the parameters and
        pools (``prefill_b{len}``, ``decode_step``, ``verify_step``,
        ``chunk_prefill``: the reference's names), which leaves the real
        pools, tables and tokens as they are."""
        if self.pad_prompts:
            buckets = self.prompt_bucket_sizes()
        else:
            buckets = tuple(sorted(set(int(n) for n in prompt_lens or ())) or (1,))
        perf = self.perf
        for length in buckets:
            toks = torch.zeros((1, length), dtype=torch.int32, device=self.device)
            with self._first_call(f"prefill_b{length}"):
                self._prefill(self.params, self._prefill_template(), toks, 1)
            if perf is not None:
                perf.attach_jit(f"prefill_b{length}", self._prefill, self.params, self._caches1, toks, 1)
            self._warmed_prefill.add(int(length))
        n = self.pool.n_slots
        zeros = torch.zeros((n,), dtype=torch.int32, device=self.device)
        bt = None
        if self.paged:
            bt = torch.zeros((n, self.pager.blocks_per_slot), dtype=torch.int32, device=self.device)
        with self._first_call("decode_step"):
            self.step_logits(self.caches, zeros, zeros, bt, self.impl)
        if perf is not None:
            perf.attach_jit("decode_step", self._decode, self.params, self.caches, zeros, zeros[:, None],
                            block_tables=bt, impl=self.impl)
        if self.paged:
            reset_slot_state_paged(self.caches, 0, np.zeros((self.pager.blocks_per_slot,), np.int32))
        else:
            reset_slot_state(self.caches, 0)
        if self.speculative:
            vb = n * (self.spec_cfg.draft_k + 1)
            vzeros = torch.zeros((vb,), dtype=torch.int32, device=self.device)
            vbt = torch.zeros((vb, self.pager.blocks_per_slot), dtype=torch.int32, device=self.device)
            with self._first_call("verify_step"):
                self.step_logits(self.caches, vzeros, vzeros, vbt, self.impl)
            if perf is not None:
                perf.attach_jit("verify_step", self._decode, self.params, self.caches, vzeros, vzeros[:, None],
                                block_tables=vbt, impl=self.impl)
        if self.prefill_chunk is not None:
            toks = torch.zeros((1, self.prefill_chunk), dtype=torch.int32, device=self.device)
            with self._first_call("chunk_prefill"):
                self._chunk_step(self.params, self._chunk_tree, toks, 0, 0)
            if perf is not None:
                perf.attach_jit("chunk_prefill", self._chunk_step, self.params, self._chunk_tree, toks, 0, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return buckets

    @contextlib.contextmanager
    def _first_call(self, name: str):
        """Time a warmup call, device work included, as ``name``'s
        first-call gauge (nothing without a timer)."""
        perf = self.perf
        t0 = perf.start() if perf is not None else 0.0
        yield
        if perf is not None:
            perf.block(self.device)
            perf.record_compile(name, perf.elapsed(t0))

    def _record(self, kind: str, **fields):
        if self.recorder is not None:
            self.recorder.record(kind, **fields)

    def _ensure_rows(self, slot_index: int, rows: int):
        """Grow a slot's pages to ``rows`` rows, recording the allocation."""
        added = self.pager.ensure_rows(slot_index, rows)
        if added:
            self._record("page_alloc", slot=slot_index, pages=len(added), in_use=self.pager.alloc.in_use)

    # -- slot mechanics ------------------------------------------------------

    def needs_chunking(self, prompt_len: int) -> bool:
        """True when this prompt prefills chunk by chunk."""
        if self.prefill_chunk is None:
            return False
        return self.chunk_all or prompt_len > self.prefill_chunk

    def admit_slot(self, slot) -> int:
        """Post-``pool.admit`` hook: charge the paged reservation (binding
        and pinning any matched prefix pages) and mark chunked prompts as
        still prefilling.  Returns the prefix-cache hit in rows — chunked
        prefill resumes there (0 cold or unshared)."""
        req = slot.request
        hit = 0
        if self.paged:
            if self.prefix_cache:
                key, plan = self._plan_stash
                if key != id(req):
                    plan = self.pager.plan_prefix(req.tokens, req.prompt_len)
                self._plan_stash = (None, None)
                hit = self.pager.admit(slot.index, req.prompt_len, req.max_new_tokens, plan=plan)
            else:
                self.pager.admit(slot.index, req.prompt_len, req.max_new_tokens)
        if self.needs_chunking(req.prompt_len):
            slot.prefill_pos = hit
        if self.speculative:
            slot.draft = SlotDraft(self.spec_cfg, np.asarray(req.tokens).tolist())
        return hit

    def _scatter_insert(self, slot, one) -> None:
        if not self.paged:
            insert_slot_state(self.caches, one, slot.index)
            return
        self._ensure_rows(slot.index, slot.request.prompt_len)
        # shared prefix blocks are masked to the sentinel: the insert never
        # rewrites a read-only shared page
        row = self.pager.scatter_row(slot.index) if self.prefix_cache else self.pager.table_row(slot.index)
        insert_slot_state_paged(self.caches, one, slot.index, row)
        if self.prefix_cache:
            # the pages now hold the final prompt KV: intern the full prompt
            # pages for later warm requests (first writer wins)
            donated = self.pager.donate(slot.index, slot.request.tokens)
            if donated:
                self._record("page_donate", slot=slot.index, pages=donated)

    def _first_output(self, logits: Tensor, hidden: Tensor):
        """(first output, hidden row): the token id (a host sync), or under
        ``sampling`` the (V,) f32 logits row on the host."""
        if self.sampling_enabled:
            return logits[0].float().cpu().numpy(), hidden
        return int(torch.argmax(logits[0])), hidden

    @torch.no_grad()
    def insert(self, slot):
        """Prefill an admitted request and copy its KV rows into the slot.
        Returns (first output, its hidden row (1, d_model) on the device):
        the prefill emits the request's first token (the TTFT point); with
        ``sampling`` the first output is the (V,) logits row the service
        samples from instead of the token id."""
        req = slot.request
        n = req.prompt_len
        length = self._prompt_bucket(n)
        perf = self.perf
        if perf is not None:
            name = f"prefill_b{length}"
            if int(length) in self._warmed_prefill:
                perf.cache_hit(name)
            else:
                perf.cache_miss(name)
                self._warmed_prefill.add(int(length))
            t0 = perf.start()
        padded = np.zeros((1, length), np.int32)
        padded[0, :n] = np.asarray(req.tokens, np.int32)
        logits, hidden, one = self._prefill(
            self.params, self._prefill_template(), torch.as_tensor(padded, device=self.device), n
        )
        self._scatter_insert(slot, one)
        result = self._first_output(logits, hidden)
        if perf is not None:
            perf.block(self.device)
            perf.observe(f"prefill_b{length}", perf.elapsed(t0))
        return result

    @torch.no_grad()
    def advance_prefill(self, slot):
        """Run ONE chunk of the slot's incremental prefill.  Returns None
        while the prompt is still streaming in; on the final chunk, scatters
        the finished state into the slot's pages and returns the same
        (first output, hidden row) as ``insert``.

        Only one chunked prefill is live at a time (the batch-1 work tree);
        other still-prefilling slots wait their turn while decode proceeds.
        """
        req = slot.request
        n, c = req.prompt_len, self.prefill_chunk
        if self._chunk_live is None:
            if self.prefix_cache:
                moves = self.pager.cow_moves(slot.index)
                if moves is not None:
                    # copy-on-write of the boundary page BEFORE the template
                    # gather reads it: writes never land on shared pages
                    apply_page_moves(self.caches, *moves)
                    self._record("page_cow", slot=slot.index, src=int(moves[0][0]), dst=int(moves[1][0]))
                if slot.prefill_pos > 0:
                    # warm start: seed the work tree with the shared prefix's
                    # KV rows so the chunks attend over them unrecomputed
                    load_template_from_pages(self.caches, self._chunk_tree, self.pager.table_row(slot.index))
                    self._record("page_share", slot=slot.index, rows=slot.prefill_pos,
                                 pages=self.pager.alloc.shared_count(slot.index))
            self._chunk_live = slot.index
        if self._chunk_live != slot.index:
            return None  # another prompt owns the work tree this tick
        perf = self.perf
        t0 = perf.start() if perf is not None else 0.0
        off = slot.prefill_pos
        take = min(c, n - off)
        padded = np.zeros((1, c), np.int32)
        padded[0, :take] = np.asarray(req.tokens[off:off + take], np.int32)
        logits, hidden, tree = self._chunk_step(
            self.params, self._chunk_tree, torch.as_tensor(padded, device=self.device), off, take - 1
        )
        slot.prefill_pos = off + take
        if slot.prefilling:
            if perf is not None:
                perf.block(self.device)
                perf.observe("chunk_prefill", perf.elapsed(t0))
            return None
        self._scatter_insert(slot, tree)
        self._chunk_live = None
        result = self._first_output(logits, hidden)
        if perf is not None:
            perf.block(self.device)
            perf.observe("chunk_prefill", perf.elapsed(t0))
        return result

    def prefilling_slot(self):
        """The still-prefilling slot whose chunk advances this tick: the
        owner of the live work tree, else the oldest waiting one."""
        waiting = [s for s in self.pool.active() if s.prefilling]
        if not waiting:
            return None
        for s in waiting:
            if s.index == self._chunk_live:
                return s
        return waiting[0]

    def step_logits(self, caches, lens: Tensor, tokens: Tensor, block_tables: Optional[Tensor], impl=None):
        """The model's decode step over a batch of lanes: (logits (B, V)
        f32, hidden (B, d), caches written in place).  ``decode_step`` runs
        it over the pool (B = n_slots) and ``spec_verify`` over the lanes of
        a verify (B = n_slots * (draft_k + 1)); a checking harness may run
        it on a copy of the caches with another ``impl``."""
        return self._decode(self.params, caches, lens, tokens[:, None], block_tables=block_tables, impl=impl)

    def _outputs(self, logits: Tensor) -> np.ndarray:
        """Per-lane outputs on the host (a sync): token ids (B,) int32, or
        under ``sampling`` the (B, V) f32 logits rows."""
        if self.sampling_enabled:
            return logits.float().cpu().numpy()
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def decode_step(self) -> Tuple[np.ndarray, Tensor]:
        """One batched decode over the whole pool.  Returns (next output per
        slot on the host — (N,) token ids, or (N, V) logits under
        ``sampling`` — and hidden rows (N, d_model) on the device); free and
        still-prefilling lanes are garbage the caller masks by
        ``pool.decoding_indices()``."""
        pool = self.pool
        perf = self.perf
        t0 = perf.start() if perf is not None else 0.0
        lens = torch.as_tensor(pool.cache_lens(), device=self.device)
        toks = torch.as_tensor(pool.last_tokens(), device=self.device)
        bt = None
        if self.paged:
            decoding = pool.decoding_indices()
            for i in decoding:
                # lazy page growth for the row this step writes (cannot fail:
                # admission reserved the worst case)
                self._ensure_rows(i, pool[i].pos + 1)
            tables = self.pager.block_tables()
            if self.prefix_cache:
                # still-prefilling lanes decode at position 0 and write their
                # k / v at block_tables[slot, 0] row 0: with prefix pages
                # bound at admission that would corrupt a shared page — mask
                # every non-decoding lane's row to the sentinel
                tables[np.setdiff1d(np.arange(pool.n_slots), decoding)] = 0
            bt = torch.as_tensor(tables, device=self.device)
        logits, hidden, self.caches = self.step_logits(self.caches, lens, toks, bt, self.impl)
        out = self._outputs(logits)  # a host sync
        if perf is not None:
            perf.block(self.device)
            perf.observe("decode_step", perf.elapsed(t0))
        return out, hidden

    # -- speculative decoding -------------------------------------------------

    @torch.no_grad()
    def spec_verify(self, drafts):
        """One lane-batched speculative verify over the whole pool.

        ``drafts`` lists ``(slot_index, draft_tokens)`` for every decoding
        slot this tick (``draft_tokens`` may be empty: that slot rides lane
        0 only, which is exactly its plain decode step).  Lane ``(s, j)`` of
        the fixed ``n_slots * (draft_k + 1)`` batch decodes slot ``s`` at
        ``cache_len = pos + j`` with input token ``last_token`` (j = 0) or
        ``draft[j - 1]``.  Drafted slots read and write through
        scratch-mapped table rows (``PagedKVManager.spec_begin``), whose
        boundary-page copies run first; unused lanes are masked like free
        pool lanes (cache_len 0, sentinel rows).

        Returns ``(out, hidden, tickets)``: ``(n_slots, draft_k + 1)`` token
        ids on the host, ``(n_slots, draft_k + 1, d_model)`` hidden rows on
        the device, and the per-slot scratch tickets the caller settles with
        ``spec_commit`` (always — lane 0's write is real even when the whole
        draft is rejected) or ``spec_rollback`` (error paths only)."""
        width = self.spec_cfg.draft_k + 1
        nb = self.pager.blocks_per_slot
        n = self.pool.n_slots
        lens = np.zeros((n * width,), np.int32)
        toks = np.zeros((n * width,), np.int32)
        tables = np.zeros((n * width, nb), np.int32)  # sentinel-masked lanes
        tickets = {}
        copies = []
        for slot_index, draft in drafts:
            s = self.pool[slot_index]
            k_eff = len(draft)
            if k_eff:
                ticket, moves = self.pager.spec_begin(slot_index, s.pos, k_eff)
                tickets[slot_index] = ticket
                copies.extend(moves)
                row = ticket.row
            else:
                # undrafted slot: plain decode through its real table row
                self._ensure_rows(slot_index, s.pos + 1)
                row = self.pager.table_row(slot_index)
            base = slot_index * width
            for j in range(k_eff + 1):
                lens[base + j] = s.pos + j
                toks[base + j] = s.last_token if j == 0 else draft[j - 1]
                tables[base + j] = row
        perf = self.perf
        t0 = perf.start() if perf is not None else 0.0
        try:
            if copies:
                src, dst = zip(*copies)
                apply_page_moves(self.caches, src, dst)
            dev = self.device
            logits, hidden, self.caches = self.step_logits(
                self.caches, torch.as_tensor(lens, device=dev), torch.as_tensor(toks, device=dev),
                torch.as_tensor(tables, device=dev), self.impl,
            )
            out = self._outputs(logits)
        except Exception:
            # a failed device step must not leak the scratch inventory
            for ticket in tickets.values():
                self.pager.spec_rollback(ticket)
            raise
        if perf is not None:
            perf.block(self.device)
            perf.observe("verify_step", perf.elapsed(t0))
        return out.reshape(n, width), hidden.reshape(n, width, -1), tickets

    def spec_commit(self, ticket, n_written: int):
        """Promote ``n_written`` verified rows into the slot's block table
        (a table swap — no device copy on the accept path)."""
        self.pager.spec_commit(ticket, n_written)

    def spec_rollback(self, ticket):
        """Discard a speculative window, restoring the table state exactly."""
        self.pager.spec_rollback(ticket)

    def abort_slot(self, index: int):
        """Host-only cleanup for a slot whose device step failed: drop any
        chunked prefill it owns and hand back its pages and reservation (no
        device ops — the device may be wedged)."""
        if self._chunk_live == index:
            self._chunk_live = None
        if self.paged:
            before = self.pager.alloc.in_use
            self.pager.release(index)
            self._record("page_free", slot=index, abort=True, pages=before - self.pager.alloc.in_use,
                         in_use=self.pager.alloc.in_use)

    @torch.no_grad()
    def release(self, index: int):
        """Retire a slot: zero its cache rows or exclusive pages and its
        recurrent state (hygiene; decode masks the rows, and a reused slot
        starts from a fresh insert), return its pages and reservation, and
        compact the page pool (copy-on-retire: the highest in-use pages
        move into the freed low holes; shared and pinned pages stay put)."""
        if self._chunk_live == index:
            self._chunk_live = None
        if not self.paged:
            reset_slot_state(self.caches, index)
            return
        # under prefix caching, pages another owner still maps (shared
        # prefixes, donated pages) are masked out of the zeroing
        row = self.pager.reset_row(index) if self.prefix_cache else self.pager.table_row(index)
        reset_slot_state_paged(self.caches, index, row)
        before = self.pager.alloc.in_use
        self.pager.release(index)
        self._record("page_free", slot=index, pages=before - self.pager.alloc.in_use, in_use=self.pager.alloc.in_use)
        src, dst = self.pager.plan_compaction()
        if src.size:
            self._record("page_compact", moves=int((src != dst).sum()))
            apply_page_moves(self.caches, src, dst)
