"""Model FLOPs of the window's SSL steps (``bench/counts/ssl.py``) over the
window's time and the float32 peak, in %."""

from bench.counts import peaks


def read(rec):
    if rec["driver"] != "ssl_train":
        return None
    flops = rec["counts"]["model_flops_per_step"] * rec["steps"]
    return 100.0 * flops / rec["window_s"] / peaks.DTYPE_FLOPS[rec["config"].get("dtype", "float32")]
