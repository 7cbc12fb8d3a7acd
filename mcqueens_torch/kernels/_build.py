"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source has a plain C entry point (no PyTorch headers, so
a build takes seconds); ``csrc/*.cuh`` holds device code they share.  ``nvcc`` compiles the sources in parallel, one
process each, all started together, and links the objects into one shared
library loaded with ``ctypes``.  The library goes to ``build/mcqueens_torch/``
at the root of the checkout, named by a hash of all the sources, headers
and flags, so an edited source is rebuilt and an unchanged tree is loaded as is.
Nothing is built or imported until a CUDA launch asks for it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG.parents[1] / "build" / "mcqueens_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# Entry point -> argument types (pointers, then ints, then the stream).
ENTRY_POINTS = {
    "mcq_board_shared_segment": [_P] * 14 + [_I] * 12 + [_P],
    "mcq_board_scan_segment": [_P] * 14 + [_I] * 10 + [_P],
    "mcq_full3d_scan_segment": [_P] * 15 + [_I] * 11 + [_P],
    "mcq_full3d_shared_segment": [_P] * 17 + [_I] * 13 + [_P],
    "mcq_metropolis_segment": [_P] * 11 + [_I] * 10 + [_P],
    "mcq_full3d_pallas_segment": [_P] * 16 + [_I] * 11 + [_P],
    "mcq_probe_vpu": [_P] * 2 + [_I] * 6 + [_P],
    "mcq_probe_op": [_P] * 2 + [_I] * 5 + [_P],
    "mcq_probe_test": [_P] * 2 + [_I] * 7 + [_P],
    "mcq_probe_sweep": [_P] * 4 + [_I] * 4 + [_P],
    "mcq_probe_gather": [_P] * 3 + [_I] * 4 + [_P],
    "mcq_probe_gather_chain": [_P] * 4 + [_I] * 7 + [_P],
    "mcq_probe_slice": [_P] * 3 + [_I] * 5 + [_P],
    "mcq_probe_slice_loop": [_P] * 2 + [_I] * 5 + [_P],
    "mcq_probe_reduce": [_P] * 2 + [_I] * 5 + [_P],
    "mcq_probe_prng": [_P] + [_I] * 6 + [_P],
}
# Shared memory one block may opt into on the H100 (sm_90), an SM's
# shared memory, and what the card reserves of it for each resident block.
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024


def check_args(dev, want) -> None:
    """Raise ``ValueError`` unless every ``name -> (tensor, shape, dtype)``
    of ``want`` is a contiguous tensor of that shape and dtype on ``dev``."""
    for name, (t, shape, dtype) in want.items():
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(
                f"{name}: want contiguous {dtype} {tuple(shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        key.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"mcqueens_kernels_{key.hexdigest()[:16]}.so"


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    return " ".join(cmd) + "\n" + proc.stdout + proc.stderr


def build() -> Path:
    """Compile the kernel library unless it is already built; return it.

    The compilers' output (``-Xptxas=-v``: registers, spills per kernel) is
    kept beside the library as ``.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        text = proc.communicate()[0]
        logs.append(f"{' '.join(proc.args)}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{text}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    logs.append(_run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                      *map(str, objs)]))
    out.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out


def ptxas_usage(text: str | None = None) -> dict[str, dict[str, int]]:
    """``{mangled kernel: {"registers": n, "spill_bytes": n}}`` from
    ``-Xptxas=-v`` output (``text``, or the built library's ``.log``):
    each entry function's registers and its spill stores plus loads."""
    if text is None:
        text = library_path().with_suffix(".log").read_text()
    out, entry, props = {}, None, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m[1]
            out[entry] = {"registers": 0, "spill_bytes": 0}
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m[1]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and props in out:
            out[props]["spill_bytes"] = int(m[1]) + int(m[2])
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            out[entry]["registers"] = int(m[1])
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its entry points' argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
