"""Tokens stepped a second over the whole window, on the host clock."""


def read(rec):
    if "tokens" not in rec["work"]:
        return None
    return rec["steps"] * rec["work"]["tokens"] / rec["window_s"]
