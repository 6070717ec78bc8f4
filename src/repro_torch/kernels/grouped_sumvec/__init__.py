"""Grouped (block) sumvec: ``pmatmul`` / ``freq_outer`` / ``freq_mat`` kernels and their ops."""
