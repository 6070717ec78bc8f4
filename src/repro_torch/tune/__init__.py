"""Plan choices the port shares with ``repro.tune``.

Only the analytic pieces the serving slice needs are ported: the four-step
FFT plan (``space`` candidates ranked by ``cost``) and the grouped block-size
candidates.  The tile tuner itself (TPU lane / sublane / VMEM rules, JSON
cache, measured tiers) has no counterpart yet.
"""
