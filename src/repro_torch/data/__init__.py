"""Deterministic synthetic data of the port (the LM token stream and the SSL
two-view stream)."""

from repro_torch.data.synthetic import LMDataConfig, SSLDataConfig, lm_batch, lm_iterator, ssl_batch, ssl_iterator
