"""repro_torch.serve — the batched embedding-serving path of the port.

  * ``buckets``  — shape buckets + admission policy (``BucketPolicy``);
  * ``batcher``  — bounded FIFO + futures + coalescing + backpressure;
  * ``engine``   — ``ServeEngine``: bucket-padded SSL encoder+projector forward;
  * ``probes``   — ``DecorrProbe``: streaming R_sum / R_off health metrics;
  * ``service``  — ``EmbeddingService``: the dispatch loop wiring them together;
  * ``loadgen``  — deterministic load + naive-vs-micro-batched comparison;
  * ``cli``      — ``python -m repro_torch.serve.cli``.
"""
