"""Model configurations of the port: ``ssl_paper`` (the embedding and
training slices) and the ten LM archs of the reference's registry.

``get_config(name)`` / ``list_archs()`` resolve an arch id like the
reference's registry (``repro/configs/__init__.py``).
"""

from __future__ import annotations

import importlib
from typing import List

_ARCHS = {
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "nemotron-4-340b": "repro_torch.configs.nemotron4_340b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "ssl-paper": "repro_torch.configs.ssl_paper",
}


def list_archs() -> List[str]:
    """The LM arch ids (every registered config but ``ssl-paper``)."""
    return [k for k in _ARCHS if k != "ssl-paper"]


def get_config(name: str):
    """The config of arch ``name``; raises ``KeyError`` for an unknown one."""
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(_ARCHS[name]).config()
