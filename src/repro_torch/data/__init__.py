"""Deterministic synthetic data of the port (the LM token stream and the SSL
two-view stream) and the prefetching pipeline that places batches on the
device."""

from repro_torch.data.pipeline import ShardedPrefetcher
from repro_torch.data.synthetic import LMDataConfig, SSLDataConfig, lm_batch, lm_iterator, ssl_batch, ssl_iterator
