"""Architecture configs and shared layer primitives (port of
``repro/models/common.py``).

A model is a decoder stack described by a repeating *pattern* of
``BlockSpec`` entries (mixer kind + FFN kind).  Parameters of each pattern
position are stacked across its repetitions (leading ``repeats`` axis), the
reference's ``lax.scan`` layout, so one layer's weights are a contiguous
slice ``leaf[r]`` and the reference's parameters carry over leaf for leaf.

Dtypes are torch dtypes.  Only the dense attention families are ported here;
MoE, Mamba / RWKV and M-RoPE belong to a later slice and raise where the
model would reach them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer position in the repeating pattern."""

    mixer: str = "attn"  # attn | mamba | rwkv
    attn_type: str = "global"  # global | local (sliding window)
    ffn: str = "dense"  # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One decoder architecture (the reference's fields the serving path reads)."""

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
    mrope: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    window_size: int = 4096  # for local layers
    attn_scale: Optional[float] = None
    # beyond this many prompt tokens the reference switches to its chunked
    # (flash-style) prefill, which a later slice ports
    attn_chunk_threshold: int = 8192
    attn_chunk_size: int = 2048

    # mlp
    activation: str = "swiglu"  # swiglu | gelu | squared_relu

    # norms / embeddings
    rms_eps: float = 1e-6
    post_block_norm: bool = False  # gemma2 sandwich norm
    scale_embed: bool = False  # gemma2: * sqrt(d_model)
    tie_embeddings: bool = True
    frontend: str = "none"  # none | vision_stub | audio_codes

    # dtypes
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

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

    def param_count(self) -> int:
        """Total parameter count (embedding + blocks; dense attention families)."""
        d, ff, hd, h, kv = self.d_model, self.d_ff, self.hd, self.n_heads, self.n_kv_heads
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2) + d  # + final norm
        mults = 3 if self.activation in ("swiglu", "geglu") else 2
        for spec in self.pattern:
            blk = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d if spec.mixer == "attn" else 0
            blk += mults * d * ff if spec.ffn == "dense" else 0
            blk += (4 if self.post_block_norm else 2) * d
            total += blk * self.repeats
        return total

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
            window_size=16,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def unsupported(cfg: ArchConfig) -> Optional[str]:
    """Why this port cannot run ``cfg`` yet (None when it can)."""
    if cfg.frontend != "none":
        return f"frontend {cfg.frontend!r}"
    if cfg.mrope:
        return "M-RoPE"
    for spec in cfg.pattern:
        if spec.mixer != "attn":
            return f"{spec.mixer} mixers"
        if spec.ffn != "dense":
            return f"{spec.ffn} FFNs"
    return None


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for the families a later slice ports."""
    why = unsupported(cfg)
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} are not ported yet (slice 3b of the port: MoE, "
            "Mamba / RWKV and M-RoPE model families)"
        )


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
    return (w * (1.0 / math.sqrt(shape[-2]))).to(dtype)


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
    """Dense MLP: ``act(x W_in) W_out``, gated when ``w_gate`` is present."""
    act = activation_fn(cfg.activation)
    cd = cfg.compute_dtype
    h = x @ params["w_in"].to(cd)
    if "w_gate" in params:
        h = act(x @ params["w_gate"].to(cd)) * h
    else:
        h = act(h)
    return h @ params["w_out"].to(cd)
