"""Perf-iteration runner (port of ``repro/launch/perf.py``): analyse one
cell with a named variant's config overrides, re-derive the roofline, and
print it.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch rwkv6-3b --shape train_4k \
        --variant rwkv_chunk64 --out perf_results
    PYTHONPATH=src python -m repro_torch.launch.perf --device cpu --arch gemma2-2b --shape decode_32k

Variants are explicit, named, and recorded — each maps to one hypothesis of
the reference's §Perf, with the reference's names and overrides.  A cell is
``launch/dryrun``'s (the port's per-rank program on fake tensors under a
``fake`` process group, analysed by ``launch/hlo_cost``); ``shard_grad_acc``
hands the step the specs' shardings as ``grad_shardings`` (each microbatch's
gradient reduce-scattered along ``data`` where a leaf's spec splits over it
alone).  ``seq_shard_attention`` (``seqpar_attn``, ``arctic_best``) splits
the query rows over ``model`` where the heads do not split
(``models/attention._scoring_attention``).  ``ssm_unroll`` steers XLA
alone and changes nothing in the port's program: its records equal the
baseline's, which is the measurement.
"""

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional

from repro_torch.configs import get_config
from repro_torch.core.decorrelation import LMDecorrConfig
from repro_torch.decorr.config import DecorrConfig
from repro_torch.launch import specs as S
from repro_torch.launch.dryrun import analyze_cell, build_cell, model_flops, record_analysis


@dataclasses.dataclass
class Variant:
    name: str
    hypothesis: str
    cfg_overrides: Dict = dataclasses.field(default_factory=dict)
    microbatches: Optional[int] = None
    decorr: Optional[str] = None  # None | off | sum | sum_b128 | sum_global
    shard_grad_acc: bool = False


def _decorr_cfg(kind: str) -> LMDecorrConfig:
    if kind == "off":
        return LMDecorrConfig(
            enabled=True, decorr=DecorrConfig(style="vic", reg="off"), nu=0.04, tokens_per_seq=8
        )
    block = 128 if kind == "sum_b128" else None
    dist = "global" if kind == "sum_global" else "local"
    return LMDecorrConfig(
        enabled=True,
        decorr=DecorrConfig(style="vic", reg="sum", q=2, block_size=block, distributed=dist),
        nu=0.04,
        tokens_per_seq=8,
    )


VARIANTS: Dict[str, Variant] = {
    "baseline": Variant("baseline", "as-shipped configuration"),
    # --- rwkv6 memory hillclimb ---
    "rwkv_chunk32": Variant(
        "rwkv_chunk32",
        "chunk-parallel recurrence (C=32) turns 4096 sequential state round-trips "
        "into 128 chunk matmuls: memory term ~ /C, compute term rises slightly",
        {"rwkv_chunk": 32},
    ),
    "rwkv_chunk64": Variant(
        "rwkv_chunk64",
        "same, C=64: more intra-chunk matmul FLOPs, fewer state round-trips",
        {"rwkv_chunk": 64},
    ),
    "rwkv_chunk128": Variant(
        "rwkv_chunk128",
        "C=128: intra-chunk O(S*C*hd) FLOPs may start to dominate",
        {"rwkv_chunk": 128},
    ),
    # --- mamba/jamba ---
    "ssm_unroll8": Variant(
        "ssm_unroll8",
        "unroll the selective-scan 8x so XLA keeps h in registers across steps",
        {"ssm_unroll": 8},
    ),
    "rwkv_chunk64_dots": Variant(
        "rwkv_chunk64_dots",
        "chunked recurrence + dots_saveable remat: skip recomputing matmul "
        "outputs in bwd (trade saved residuals for fewer recompute passes)",
        {"rwkv_chunk": 64, "remat_policy": "dots"},
    ),
    "jamba_opt": Variant(
        "jamba_opt",
        "ssm unroll 8 + grouped MoE dispatch + flash attention for the hybrid",
        {"ssm_unroll": 8, "moe_group_size": 4096, "attn_chunk_threshold": 2048, "attn_chunk_size": 1024},
    ),
    # --- attention memory ---
    "flash_train": Variant(
        "flash_train",
        "chunked online-softmax attention at train seq 4096 removes the "
        "materialized (S,S) score/mask tensors from HBM",
        {"attn_chunk_threshold": 2048, "attn_chunk_size": 1024},
    ),
    # --- MoE ---
    "moe_group4k": Variant(
        "moe_group4k",
        "dispatch per 4096-token group: dispatch einsum O(T*G) instead of O(T^2)",
        {"moe_group_size": 4096},
    ),
    "moe_group2k": Variant(
        "moe_group2k", "dispatch per 2048-token group", {"moe_group_size": 2048}
    ),
    "moe_group4k_micro8": Variant(
        "moe_group4k_micro8",
        "grouped dispatch (linear in T) makes fewer microbatches affordable: "
        "halves the per-step FSDP weight re-gathers without the dispatch "
        "quadratic blowup",
        {"moe_group_size": 4096},
        microbatches=8,
    ),
    "moe_group4k_micro4": Variant(
        "moe_group4k_micro4",
        "same, 4 microbatches: quarter the weight re-gathers",
        {"moe_group_size": 4096},
        microbatches=4,
    ),
    "moe_group4k_micro2": Variant(
        "moe_group4k_micro2",
        "2 microbatches; activation memory may exceed HBM",
        {"moe_group_size": 4096},
        microbatches=2,
    ),
    "moe_group4k_micro8_shacc": Variant(
        "moe_group4k_micro8_shacc",
        "grouped dispatch + 8 microbatches + FSDP-sharded gradient "
        "accumulator: per-microbatch grads reduce-scatter into shards "
        "instead of all-reducing replicated full gradients",
        {"moe_group_size": 4096},
        microbatches=8,
        shard_grad_acc=True,
    ),
    "moe_group4k_micro16_shacc": Variant(
        "moe_group4k_micro16_shacc",
        "sharded accumulator at the baseline microbatch count",
        {"moe_group_size": 4096},
        microbatches=16,
        shard_grad_acc=True,
    ),
    "arctic_best": Variant(
        "arctic_best",
        "grouped dispatch + 8 microbatches + sequence-parallel attention "
        "(56 heads unshardable over 16-way model axis: shard q-seq instead "
        "of replicating head compute, killing score-sized bwd all-reduces)",
        {"moe_group_size": 4096, "seq_shard_attention": True},
        microbatches=8,
    ),
    "seqpar_attn": Variant(
        "seqpar_attn",
        "sequence-parallel attention only (vs baseline)",
        {"seq_shard_attention": True},
    ),
    # --- microbatching ---
    "micro8": Variant("micro8", "half the weight re-gathers per step", microbatches=8),
    "micro4": Variant("micro4", "quarter the weight re-gathers per step", microbatches=4),
    "micro2": Variant("micro2", "2 microbatches", microbatches=2),
    # --- the paper's technique on the LM cell ---
    "decorr_off_baseline": Variant(
        "decorr_off_baseline",
        "PAPER BASELINE: VICReg-style R_off on hidden states (materializes d x d)",
        decorr="off",
    ),
    "decorr_sum": Variant(
        "decorr_sum",
        "PAPER: R_sum via FFT (q=2 Parseval) — loss node O(nd log d)",
        decorr="sum",
    ),
    "decorr_sum_b128": Variant(
        "decorr_sum_b128",
        "PAPER+TPU: grouped b=128 (MXU DFT-matmul shape)",
        decorr="sum_b128",
    ),
    "decorr_sum_global": Variant(
        "decorr_sum_global",
        "BEYOND-PAPER: exact global-batch statistic via one psum of the "
        "frequency accumulator",
        decorr="sum_global",
    ),
}


def build_and_analyze(
    arch: str, shape_name: str, variant: Variant, multi_pod: bool = False, device=None, *,
    reduced: bool = False, mesh_shape=None,
) -> Dict:
    """The variant's cell record (``reduced``: the arch's ``reduced()``
    widths; ``mesh_shape``: a smaller mesh — both for tests)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if variant.cfg_overrides:
        cfg = dataclasses.replace(cfg, **variant.cfg_overrides)
    if variant.decorr is not None:
        cfg = dataclasses.replace(cfg, decorr=_decorr_cfg(variant.decorr))
    shape = S.SHAPES[shape_name]
    rec: Dict = {"arch": arch, "shape": shape_name, "variant": variant.name,
                 "hypothesis": variant.hypothesis, "multi_pod": multi_pod}
    kw = dict(device=device, cfg=cfg, microbatches=variant.microbatches, grad_shardings=variant.shard_grad_acc,
              mesh_shape=mesh_shape)
    fn, args, meta = build_cell(arch, shape_name, multi_pod, **kw)
    if fn is None:
        raise ValueError(f"{arch} x {shape_name}: {meta['skip']}")
    if "num_microbatches" in meta:
        rec["num_microbatches"] = meta["num_microbatches"]
    rec["layout"] = meta["layout"]
    rec["reference_argument_bytes"] = meta["reference_argument_bytes"]
    t0 = time.time()
    analysis = analyze_cell(fn, args, meta, lambda runs: build_cell(arch, shape_name, multi_pod, runs=runs, **kw))
    rec["compile_s"] = round(time.time() - t0, 2)
    record_analysis(rec, analysis)
    n_dev = math.prod(mesh_shape) if mesh_shape is not None else 512 if multi_pod else 256
    rec["model_flops_per_device"] = model_flops(cfg, shape) / n_dev
    rec["useful_flops_ratio"] = rec["model_flops_per_device"] / max(analysis.flops, 1)
    return rec


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="perf_results")
    ap.add_argument("--device", default=None, help="'cuda' (default: the kernel route) or 'cpu' (the plain route)")
    args = ap.parse_args(argv)

    v = VARIANTS[args.variant]
    rec = build_and_analyze(args.arch, args.shape, v, args.multi_pod, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}__{args.shape}__{v.name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    rl = rec["roofline"]
    print(json.dumps({
        "variant": v.name, "compile_s": rec["compile_s"],
        "compute_s": round(rl["compute_s"], 3), "memory_s": round(rl["memory_s"], 3),
        "collective_s": round(rl["collective_s"], 3), "dominant": rl["dominant"],
        "bound_s": round(rl["bound_s"], 3), "useful": round(rec["useful_flops_ratio"], 4),
        "tempGB": round(rec["memory"]["temp_bytes"] / 1e9, 1),
    }))


if __name__ == "__main__":
    main()
