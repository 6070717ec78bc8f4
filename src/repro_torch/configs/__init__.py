"""Model configurations of the port: ``ssl_paper`` (the embedding and
training slices) and the LM archs the serving slice runs.

``get_config(name)`` resolves an arch id like the reference's registry; the
archs whose model families are not ported yet raise and name their slice.
"""

from __future__ import annotations

import importlib
from typing import List

_PORTED = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "ssl-paper": "repro_torch.configs.ssl_paper",
}
# the reference's other archs and the port slice that brings their families
_LATER = {
    "qwen2-vl-2b": "3b (M-RoPE)",
    "qwen1.5-110b": "3b (dense LM archs beyond gemma2-2b)",
    "nemotron-4-340b": "3b (dense LM archs beyond gemma2-2b)",
    "codeqwen1.5-7b": "3b (dense LM archs beyond gemma2-2b)",
    "arctic-480b": "3b (MoE)",
    "llama4-scout-17b-a16e": "3b (MoE)",
    "jamba-v0.1-52b": "3b (Mamba + MoE)",
    "rwkv6-3b": "3b (RWKV)",
    "musicgen-large": "3b (audio codes)",
}


def list_archs() -> List[str]:
    """LM arch ids this port can build."""
    return [k for k in _PORTED if k != "ssl-paper"]


def get_config(name: str):
    """The config of a ported arch; raises for unknown or not-yet-ported ones."""
    if name in _LATER:
        raise NotImplementedError(f"arch {name!r} is not ported yet: slice {_LATER[name]} brings it")
    if name not in _PORTED:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_PORTED) + sorted(_LATER)}")
    return importlib.import_module(_PORTED[name]).config()
