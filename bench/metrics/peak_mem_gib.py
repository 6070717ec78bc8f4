"""The allocator's peak over set-up, the window and the traced extras
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2**30
