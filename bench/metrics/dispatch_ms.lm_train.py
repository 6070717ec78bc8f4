"""Host milliseconds a timed call takes to return (``bench/benchlib/readers.dispatch_ms``)."""

from bench.benchlib.readers import dispatch_ms as read  # noqa: F401
