"""Decorrelation engine configuration (port of ``repro/decorr/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DecorrConfig:
    """Selects and parameterizes the decorrelating regularizer.

    style:       'bt' (cross-correlation, Eq. 14) | 'vic' (covariance, Eq. 15)
    reg:         'off' (baseline R_off) | 'sum' (proposed R_sum / R_sum^(b))
    block_size:  None => no grouping (b = d); else b (paper's best: 128)
    q:           1 | 2 (paper Table 11: q=2 for BT-style, q=1 for VICReg-style)
    permute:     feature permutation each step (essential; paper Table 5)
    lam:         BT lambda
    alpha/mu/nu: VICReg coefficients;  gamma: target std
    distributed: 'local' | 'global' | 'tp'  (see ``decorr/modes.py``)
    axis_name:   mesh axis the BATCH is sharded over ('global'/'tp' modes);
                 None means single-shard semantics even in 'global' mode
    model_axis:  mesh axis the FEATURE dim is sharded over — required by the
                 'tp' mode (the engine refuses to run 'tp' without it rather
                 than silently computing the shard-local loss)
    use_kernel:  pin the regularizer to the kernel route (False lets the
                 tensor's device pick: CUDA -> kernels, CPU -> plain)
    """

    style: str = "bt"
    reg: str = "sum"
    block_size: Optional[int] = None
    q: int = 2
    permute: bool = True
    lam: float = 2.0**-10
    alpha: float = 25.0
    mu: float = 25.0
    nu: float = 1.0
    gamma: float = 1.0
    eps: float = 1e-5
    distributed: str = "local"
    axis_name: Optional[str] = None
    model_axis: Optional[str] = None
    use_kernel: bool = False

    def validate(self) -> "DecorrConfig":
        """Raise on an unknown style / reg / q / mode; returns self."""
        if self.style not in ("bt", "vic"):
            raise ValueError(f"style must be 'bt' or 'vic', got {self.style!r}")
        if self.reg not in ("off", "sum"):
            raise ValueError(f"reg must be 'off' or 'sum', got {self.reg!r}")
        if self.q not in (1, 2):
            raise ValueError(f"q must be 1 or 2, got {self.q!r}")
        if self.distributed not in ("local", "global", "tp"):
            raise ValueError(f"unknown distributed mode {self.distributed!r}")
        return self

    @property
    def mode(self) -> str:
        """The effective distribution mode: 'global' with no ``axis_name``
        is the local computation; 'tp' never degrades."""
        if self.distributed == "global" and self.axis_name is None:
            return "local"
        return self.distributed
