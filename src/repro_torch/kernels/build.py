"""Build the package's CUDA C++ kernels at first use and load them.

Each ``csrc/<family>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers: a build takes seconds, not
minutes), and is loaded with ``ctypes``.  All sources start compiling
together, one ``nvcc`` process each, the first time any kernel is asked for.
Libraries land in ``build/kernels/`` at the repository root (git-ignored),
named by a hash of their source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source never loads a stale library.

Target: ``sm_90a`` (Hopper).  Nothing here runs at import time: the CPU-only
tests import every module, and only a launch on a CUDA tensor builds.

A launch whose operands are fake (``FakeTensor``: the op-level cost
analyzer ``launch/hlo_cost.analyze`` runs a path on fake copies) builds and
calls nothing: it reports (family, name, the tensor operands, the scalar
operands) to the analysis that owns the operands' fake mode and returns
False.  A real launch reports to an analysis open on its thread, if any.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.utils import is_fake

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FAMILIES = ("sumvec_fft", "grouped_sumvec", "xcorr_offdiag", "paged_attention")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# open analyses: keyed by id(fake mode) for fake launches (a backward pass
# runs on autograd's threads) and by thread id for real ones
_RECORDERS: Dict[Tuple[str, int], Callable] = {}


def add_recorder(fake_mode, record: Callable) -> Callable[[], None]:
    """Report every launch on ``fake_mode``'s tensors, and every real
    launch of this thread, to ``record(family, name, args)`` until the
    returned function is called."""
    keys = (("mode", id(fake_mode)), ("thread", threading.get_ident()))
    for key in keys:
        _RECORDERS[key] = record

    def remove() -> None:
        for key in keys:
            _RECORDERS.pop(key, None)

    return remove


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _target(family: str) -> Path:
    # the source, every shared header beside it and the flags name the library
    src = (CSRC / f"{family}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{family}_{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every family not yet built, all ``nvcc`` processes at once.

    Returns {family: library path}.  Raises with the compiler's output when
    any source fails to build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {fam: _target(fam) for fam in FAMILIES}
    procs = {}
    nvcc = None
    for fam, out in targets.items():
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{fam}.cu")]
        procs[fam] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for fam, (tmp, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {fam}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, targets[fam])
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(family: str) -> ctypes.CDLL:
    """The loaded kernel library of ``family``, building all of them first
    if needed (thread-safe: the serve dispatch thread may be the first)."""
    with _lock:
        lib = _LIBS.get(family)
        if lib is None:
            paths = build_all()
            for fam, path in paths.items():
                _LIBS.setdefault(fam, ctypes.CDLL(str(path)))
            lib = _LIBS[family]
        return lib


def _ctype(arg):
    """C type of one launch argument: int -> int, float -> float, anything
    else (a tensor, None) -> a pointer."""
    if isinstance(arg, int):
        return ctypes.c_int
    if isinstance(arg, float):
        return ctypes.c_float
    return ctypes.c_void_p


def _function(family: str, name: str, args) -> "ctypes._CFuncPtr":
    fn = _FNS.get((family, name))
    if fn is None:
        fn = getattr(library(family), f"{family}_{name}")
        # pointers (tensors, or None for NULL) and the stream as c_void_p: a
        # bare Python int would be passed as a 32-bit int and cut the address
        fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[(family, name)] = fn
    return fn


def launch(family: str, name: str, device: torch.device, *args) -> bool:
    """Call ``<family>_<name>`` on ``device``'s current stream and raise if
    the launch failed; True when it launched.  ``args``: CUDA tensors
    (passed by data pointer), None (a NULL pointer), Python ints (C ints) or
    floats (C floats), in the C signature's order; the stream is appended.
    Does not synchronise.  Fake operands launch nothing and return False
    (see the module note); the wrappers count a launch only on True.

    The common case — ``device`` is already the current device — costs one
    raw stream lookup and the ctypes call: no device guard is entered and no
    ``torch.cuda.Stream`` object is built."""
    if is_fake(*args):
        mode = next(a.fake_mode for a in args if is_fake(a))
        record = _RECORDERS.get(("mode", id(mode)))
        if record is not None:
            record(family, name, args)
        return False
    if _RECORDERS:
        record = _RECORDERS.get(("thread", threading.get_ident()))
        if record is not None:
            record(family, name, args)
    fn = _function(family, name, args)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        code = fn(*conv, stream)
    else:
        with torch.cuda.device(index):
            code = fn(*conv, stream)
    _check_status(family, code, name)
    return True


def _check_status(family: str, code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (the C side returns
    ``cudaGetLastError()`` right after each launch)."""
    if code != 0:
        lib = library(family)
        fn = getattr(lib, f"{family}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        msg = fn(int(code)).decode(errors="replace")
        raise RuntimeError(f"{kernel}: CUDA launch failed ({code}): {msg}")
