"""Samples (batch rows of one view) stepped a second over the whole window, on the host clock."""


def read(rec):
    if "samples" not in rec["work"]:
        return None
    return rec["steps"] * rec["work"]["samples"] / rec["window_s"]
