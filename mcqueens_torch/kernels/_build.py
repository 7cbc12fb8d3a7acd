"""Build and bind the port's CUDA kernels.

``nvcc`` compiles ``csrc/board_shared.cu`` into a shared library with a plain
C entry point, loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds).  The library goes to ``build/mcqueens_torch/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as is.  Nothing is built or imported
until a CUDA launch asks for it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "board_shared.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "mcqueens_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "board_shared kernel is built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"board_shared_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless it is already built; return it.

    The compiler's output (``-Xptxas=-v``: registers, spills) is kept
    beside the library as ``.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its entry point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.mcq_board_shared_segment
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
