"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``quisk_tpu_torch/_build/`` under a name that carries a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built at import: a kernel is built
at its first launch, or all at once by :func:`build`.  A failed build
raises; nothing falls back to another path.  :func:`check_tensors` and
:func:`call` are what every wrapper does around its launcher: validate
what the pointers point at, then call on the tensor's device and stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha1((SRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (all by default), one ``nvcc`` each, all
    started together.  Returns {name: {"seconds", "log"}} for those built
    now; raises RuntimeError if any compile fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check_tensors(ref: torch.Tensor, want: dict) -> None:
    """Raise unless every ``name: (tensor, dtype, shape)`` of ``want`` lies
    on ``ref``'s device with that dtype and shape, contiguous."""
    for name, (t, dt, shape) in want.items():
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def call(ref: torch.Tensor, fn, *args) -> int:
    """Call the C launcher ``fn(*args, stream)`` on ``ref``'s device and
    current stream; returns the launcher's error code."""
    if ref.device.type != "cuda":
        raise ValueError(f"no kernel for device {ref.device}")
    with torch.cuda.device(ref.device):
        return fn(*args, torch.cuda.current_stream(ref.device).cuda_stream)
