"""The SSL loss's share of its roofline, in % (``bench/benchlib/readers.loss_roofline``)."""

from bench.benchlib.readers import loss_roofline as read  # noqa: F401
