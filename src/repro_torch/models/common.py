"""Architecture configs and shared layer primitives (port of
``repro/models/common.py``).

A model is a decoder stack described by a repeating *pattern* of
``BlockSpec`` entries (mixer kind + FFN kind).  Parameters of each pattern
position are stacked across its repetitions (leading ``repeats`` axis), the
reference's ``lax.scan`` layout, so one layer's weights are a contiguous
slice ``leaf[r]`` and the reference's parameters carry over leaf for leaf.

Dtypes are torch dtypes.  Every family of the reference is ported: dense
attention (GQA, RoPE and M-RoPE, local / global windows, softcaps), MoE
FFNs (``models.moe``), Mamba and RWKV6 mixers (``models.ssm``) and the
vision-stub and audio-code frontends.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.decorrelation import LMDecorrConfig
from repro_torch.parallel import fsdp_tp

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer position in the repeating pattern."""

    mixer: str = "attn"  # attn | mamba | rwkv
    attn_type: str = "global"  # global | local (sliding window)
    ffn: str = "dense"  # dense | moe | rwkv_cmix | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One decoder architecture (the reference's fields the serving and
    training paths read)."""

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)

    # attention options
    rope_theta: float = 10000.0
    mrope: bool = False  # qwen2-vl multimodal RoPE (3 position streams)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # halves of head_dim
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    window_size: int = 4096  # for local layers
    attn_scale: Optional[float] = None
    # beyond this many prompt tokens (a multiple of the chunk) the prefill
    # takes the chunked, flash-style path (``attention._chunked_attention``)
    attn_chunk_threshold: int = 8192
    attn_chunk_size: int = 2048
    # where the heads do not split over `model`, split attention's query
    # rows over `model` instead (``attention._scoring_attention``)
    seq_shard_attention: bool = False

    # mlp
    activation: str = "swiglu"  # swiglu | gelu | squared_relu
    mlp_bias: bool = False  # read by no layer, in the reference as here

    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None
    dense_residual: bool = False  # arctic: dense MLP in parallel with the MoE
    shared_expert: bool = False  # llama4: always-on shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # weight of the load-balance loss in a train step
    moe_group_size: Optional[int] = None  # dispatch per G-token group

    # ssm (mamba)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_chunk: Optional[int] = None  # chunk-parallel prefill recurrence
    # XLA's scan unroll hint in the reference; the port's recurrence is an
    # eager Python loop, so the field changes nothing (it exists so every
    # reference variant builds)
    ssm_unroll: int = 1

    # norms / embeddings
    rms_eps: float = 1e-6
    post_block_norm: bool = False  # gemma2 sandwich norm
    scale_embed: bool = False  # gemma2: * sqrt(d_model)
    tie_embeddings: bool = True
    frontend: str = "none"  # none | vision_stub | audio_codes
    n_codebooks: int = 4  # musicgen

    # dtypes
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    optimizer_moment_dtype: torch.dtype = torch.float32  # AdamW's m and v

    # training features: the paper's aux loss on the final hidden states
    decorr: LMDecorrConfig = dataclasses.field(default_factory=LMDecorrConfig)
    # per-layer rematerialisation while autograd records: "nothing" saves
    # no activation inside a block (recomputed in the backward pass),
    # "dots" saves the matrix products' outputs (``models.transformer``)
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots

    source: str = ""

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.pattern)}"
        )

    @property
    def repeats(self) -> int:
        """Repetitions of the pattern (the stacked parameters' leading axis)."""
        return self.n_layers // len(self.pattern)

    @property
    def hd(self) -> int:
        """Per-head width."""
        return self.head_dim if self.head_dim is not None else self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        """True when no pattern position attends (RWKV)."""
        return all(b.mixer != "attn" for b in self.pattern)

    @property
    def supports_long_context(self) -> bool:
        """True if decode cost is sub-quadratic in context (SSM / hybrid)."""
        return all(b.mixer != "attn" or b.attn_type == "local" for b in self.pattern) or (
            self.family in ("ssm", "hybrid")
        )

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings + blocks), as the
        reference computes it — its undercount included: the RWKV mixer is
        reckoned at 6 d^2 and neither the RWKV channel mix nor the audio
        embeddings and heads are counted."""
        d, ff = self.d_model, self.d_ff
        hd, h, kv = self.hd, self.n_heads, self.n_kv_heads
        mults = 3 if self.activation in ("swiglu", "geglu") else 2
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for spec in self.pattern:
            blk = 0
            if spec.mixer == "attn":
                blk += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            elif spec.mixer == "mamba":
                di = self.ssm_expand * d
                blk += d * 2 * di + di * (2 * self.ssm_d_state + di // 8) + di * d
            elif spec.mixer == "rwkv":
                blk += 4 * d * d + 2 * d * d
            if spec.ffn == "dense":
                blk += mults * d * ff
            elif spec.ffn == "moe":
                mdff = self.moe_d_ff or ff
                blk += self.n_experts * mults * d * mdff + d * self.n_experts
                if self.dense_residual:
                    blk += mults * d * ff
                if self.shared_expert:
                    blk += mults * d * mdff
            blk += 2 * d  # norms
            total += blk * self.repeats
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        mdff = self.moe_d_ff or self.d_ff
        mults = 3 if self.activation in ("swiglu", "geglu") else 2
        per_expert = mults * self.d_model * mdff
        n_moe = sum(1 for spec in self.pattern if spec.ffn == "moe")
        return self.param_count() - n_moe * (self.n_experts - self.top_k) * per_expert * self.repeats

    def reduced(self, **overrides) -> "ArchConfig":
        """Small same-family config for CPU tests (the reference's reduction)."""
        pat_len = len(self.pattern)
        small = dict(
            n_layers=2 * pat_len,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.n_experts else None,
            window_size=16,
            ssm_d_state=8,
            rwkv_head_dim=16,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
            mrope_sections=(4, 2, 2),
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Shared primitives
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm in f32; the weight is stored as (w - 1), as in the reference."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype, device=None) -> Tensor:
    """normal / sqrt(d_in) weights (``d_in`` = ``shape[-2]``), drawn in f32."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(shape[-2])).to(dtype)  # in place: no second f32 copy of a large leaf


def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    """``cap * tanh(x / cap)`` (identity for ``cap=None``)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def activation_fn(name: str):
    """The MLP activation.  ``gelu`` is the tanh approximation, which is what
    ``jax.nn.gelu`` computes by default (plain ``F.gelu`` is the erf form)."""
    if name == "squared_relu":
        return lambda x: torch.square(F.relu(x))
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    return F.silu  # swiglu gate


def mlp_apply(params: Dict[str, Tensor], x: Tensor, cfg: ArchConfig) -> Tensor:
    """Dense MLP: ``act(x W_in) W_out``, gated when ``w_gate`` is present.

    On placed blocks (``parallel/fsdp_tp``) each weight is gathered over
    ``data`` first; split over ``model``, ``w_in`` / ``w_gate`` are column
    blocks and ``w_out`` a row block, and the output is all-reduced over
    ``model`` (the entry's and exit's collectives)."""
    act = activation_fn(cfg.activation)
    cd = cfg.compute_dtype
    tp = fsdp_tp.split_over(params["w_out"], fsdp_tp.MODEL)
    if tp:
        x = fsdp_tp.enter_tp(x)

    def w(name):
        return fsdp_tp.gather(params[name], model=not tp, repeated=True, tp=tp).to(cd)

    h = x @ w("w_in")
    if "w_gate" in params:
        h = act(x @ w("w_gate")) * h
    else:
        h = act(h)
    out = h @ w("w_out")
    return fsdp_tp.exit_tp(out) if tp else out
