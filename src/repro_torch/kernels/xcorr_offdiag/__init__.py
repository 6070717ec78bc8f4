"""Fused off-diagonal penalty (R_off) kernel: CUDA forward, Gram-trick backward."""

from repro_torch.kernels.xcorr_offdiag.ops import off_diagonal_sq_sum, r_off_gram
from repro_torch.kernels.xcorr_offdiag.ref import off_diagonal_sq_sum_ref
