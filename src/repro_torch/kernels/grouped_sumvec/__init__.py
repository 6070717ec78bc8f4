"""Grouped (block) sumvec: ``pmatmul`` / ``freq_outer`` kernels and their ops."""
