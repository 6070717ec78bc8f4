"""The device's idle share of the traced stretch, in % (``bench/benchlib/readers.idle_share``)."""

from bench.benchlib.readers import idle_share as read  # noqa: F401
