"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module layout (one port file per reference
file) and imports nothing of it, nor of JAX.  Plain tensor code is PyTorch;
each Pallas TPU kernel of the reference becomes a hand-written CUDA C++
kernel (``kernels/csrc``) built at first use by ``kernels/build.py``.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``;
a kernel wrapper given a CPU tensor runs the kernel's plain PyTorch version,
and given a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``cpu`` is asked for.

    Raises when CUDA is requested (explicitly or by default) and absent —
    there is no silent move to the CPU.  On CUDA it pins full-f32 matmuls
    and convolutions (``allow_tf32 = False`` for cuBLAS and cuDNN), so the
    served embeddings keep the reference's f32 precision.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain PyTorch route"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev

