"""Deterministic synthetic data of the port (the SSL two-view stream)."""

from repro_torch.data.synthetic import SSLDataConfig, ssl_batch, ssl_iterator
