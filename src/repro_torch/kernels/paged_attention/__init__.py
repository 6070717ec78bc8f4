"""Paged decode attention: block-table KV reads for the serving slot pool.

  * ``kernel.py`` — the wrapper of the hand-written CUDA kernel
    (``kernels/csrc/paged_attention.cu``): checks, launch, counter;
  * ``ops.py``    — ``auto_page_size`` (the tuned page of a pool) and
    ``paged_decode_plain``, the plain PyTorch version (GQA heads expanded,
    then ``ref``), the CPU route and the on-card yardstick;
  * ``ref.py``    — the dense-gather oracle (masked softmax in f32).
"""

from repro_torch.kernels.paged_attention.kernel import paged_decode_attention
from repro_torch.kernels.paged_attention.ops import PAGE_PREFER, auto_page_size, paged_decode_plain
from repro_torch.kernels.paged_attention.ref import gather_pages, paged_decode_ref

__all__ = [
    "PAGE_PREFER",
    "auto_page_size",
    "gather_pages",
    "paged_decode_attention",
    "paged_decode_plain",
    "paged_decode_ref",
]
