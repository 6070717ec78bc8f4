"""The paper's own SSL setting (port of ``repro/configs/ssl_paper.py``):
Siamese backbone + 3-layer MLP projector.  The backbone is a compact
conv-free patch MLP; projector widths d in {2048 ... 16384} as in Fig. 2."""

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    """The ``ssl-paper`` model and its batch size."""

    input_dim: int = 3 * 32 * 32
    backbone_widths: Tuple[int, ...] = (512, 512)
    projector_widths: Tuple[int, ...] = (2048, 2048, 2048)
    batch_size: int = 256


def config() -> SSLConfig:
    """The default ``ssl-paper`` configuration."""
    return SSLConfig()
