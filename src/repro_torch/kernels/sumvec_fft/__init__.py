"""Four-step-FFT sumvec: ``cmatmul`` / ``ctwiddle`` kernels and their ops."""
