"""Serving launcher: batched prefill + greedy decode (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --reduced \
        --batch 4 --prompt-len 32 --new-tokens 16 --device cpu

Without ``--device cpu`` it runs on the card and raises where CUDA is
absent.  Parameters are seeded (``init_params(seed=--seed)``), the prompt
too (``make_prompt(seed=--seed + 1)``, numpy-seeded where the reference
draws from a JAX key).  For the production serving paths (micro-batching,
continuous batching, paging, the fabric) see ``python -m
repro_torch.serve.cli``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.common import make_prompt, timed_generate


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve", description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=dev)
    prompt = make_prompt(cfg, args.seed + 1, args.batch, args.prompt_len, device=dev)

    out, stats = timed_generate(params, cfg, prompt, args.new_tokens, warmup_tokens=0)
    print(f"[serve] arch={cfg.name} generated {tuple(out.shape)} in {stats['seconds']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s batch throughput)")
    print("first row:", out[0, :10].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
