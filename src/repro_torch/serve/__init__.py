"""repro_torch.serve — the embedding and LM serving paths of the port.

  * ``buckets``  — shape buckets + admission policy (``BucketPolicy``);
  * ``batcher``  — bounded FIFO + futures + coalescing + backpressure;
  * ``engine``   — ``ServeEngine`` (bucket-padded SSL encoder+projector
    forward), ``LMServeEngine`` (whole-request greedy generation) and
    ``ContinuousLMEngine`` (the continuous-batching slot pool, dense or
    paged KV cache);
  * ``slots``    — ``SlotPool``: the decode slots' host-side bookkeeping;
  * ``paging``   — page allocator, block tables and byte accounting;
  * ``probes``   — ``DecorrProbe``: streaming R_sum / R_off health metrics;
  * ``service``  — ``EmbeddingService`` and ``LMService``: the loops wiring
    them together;
  * ``common``   — prompt construction and timed greedy generation;
  * ``loadgen``  — deterministic load + policy comparisons;
  * ``cli``      — ``python -m repro_torch.serve.cli``.
"""
