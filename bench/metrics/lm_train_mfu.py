"""Model FLOPs of the window's LM steps (``bench/counts/lm.py``) over the
window's time and the peak of the configuration's compute dtype, in %."""

from bench.counts import peaks


def read(rec):
    if rec["driver"] != "lm_train":
        return None
    flops = rec["counts"]["model_flops_per_step"] * rec["steps"]
    return 100.0 * flops / rec["window_s"] / peaks.DTYPE_FLOPS[rec["config"]["compute_dtype"]]
