"""Build the port's warp kernels as host C++, to check their logic without a
GPU.

:func:`load` compiles ``csrc/board_scan.cu``, ``csrc/full3d_scan.cu``,
``csrc/board_shared.cu``, ``csrc/full3d_shared.cu``, ``csrc/metropolis.cu``,
``csrc/full3d_pallas.cu``, ``csrc/probe_gather.cu`` and
``csrc/probe_slice.cu`` with ``g++ -std=c++20 -pthread`` against
``emu/cuda_runtime.h`` (one OS thread per CUDA thread, the warp intrinsics
and ``__syncthreads`` over barriers) into one shared library with the same
C entry points as the CUDA library, and loads it with ``ctypes``.  The
modules' ``launch_segment`` then runs a kernel on CPU tensors, through the
same argument checks and layout rule as a launch on the card::

    lib = host_emulation.load()
    full3d.launch_segment(lib, st, ys, start_outer, n_outer, spec, beta,
                          n_sm=2)
    board_shared.launch_segment(lib, st, step0, n_inner, spec, beta, n_sm=2)
    full3d_shared.launch_segment(lib, st, step0, n_inner, spec, beta, n_sm=2)
    metropolis_pallas.launch_segment(lib, st, step0, n_inner, spec, beta,
                                     n_sm=2)
    full3d_pallas.launch_segment(lib, st, step0, n_inner, spec, beta, n_sm=2)
    probes_mem.launch_chain(lib, x, idx, out, axis, n_iter=n_iter)
    probes_mem.launch_prng(lib, out, mode, n_iter=n_iter)

The library goes to ``build/mcqueens_torch/host/``, named by a hash of the
sources, the header and the flags.  A source is the ``.cu`` file with its
kernel launches and ``extern __shared__`` arrays rewritten (the only CUDA
syntax g++ cannot parse; inline PTX stands under ``#ifdef __CUDA_ARCH__``
with its plain C++ beside it).  ``tests/test_torch_scan_emulation.py``,
``tests/test_torch_shared_emulation.py``,
``tests/test_torch_full3d_shared_emulation.py``,
``tests/test_torch_metropolis_emulation.py``,
``tests/test_torch_full3d_pallas_emulation.py`` and
``tests/test_torch_probes_emulation.py`` hold the emulated kernels bitwise
against their plain-torch twins.  ``emu/checks.cpp`` adds elementwise entry
points of the header's integer intrinsics and a whole-range check of the
exact divider (``csrc/exact_div.cuh``), which
``tests/test_torch_shared_emulation.py`` holds to plain models.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

from mcqueens_torch.kernels import _build

EMU_DIR = _build._PKG / "emu"
SOURCES = tuple(_build._PKG / "csrc" / f"{name}.cu"
                for name in ("board_scan", "full3d_scan", "board_shared",
                             "full3d_shared", "metropolis", "full3d_pallas",
                             "probe_gather", "probe_slice"))
# Built beside them as it is: entry points of the integer intrinsics and of
# the exact divider, for the tests only.
CHECKS = EMU_DIR / "checks.cpp"
BUILD_DIR = _build.BUILD_DIR / "host"
CXX_FLAGS = ("-std=c++20", "-O1", "-pthread", "-fPIC", "-shared",
             "-ffp-contract=off", "-w")
ENTRY_POINTS = ("mcq_board_scan_segment", "mcq_full3d_scan_segment",
                "mcq_board_shared_segment", "mcq_full3d_shared_segment",
                "mcq_metropolis_segment", "mcq_full3d_pallas_segment",
                "mcq_probe_gather_chain", "mcq_probe_prng")

_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<([^>]*)>>>\(([^;]*)\);")
_SHARED = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


def compiler():
    """The host C++ compiler, or None."""
    return shutil.which("g++")


def translate(text: str) -> str:
    """A ``.cu`` source as host C++ for ``emu/cuda_runtime.h``."""
    text = _LAUNCH.sub(r"emu::launch(\1, \2, \3);", text)
    return _SHARED.sub(
        r"\1* \2 = reinterpret_cast<\1*>(emu::shared_memory());", text)


def library_path():
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in (*SOURCES, *_build.HEADERS, EMU_DIR / "cuda_runtime.h",
                CHECKS):
        key.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"mcqueens_host_{key.hexdigest()[:16]}.so"


def build():
    """Compile the emulated kernels unless already built; return the
    library's path."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no g++: the host emulation needs a C++20 "
                           "compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    cpps = []
    for src in SOURCES:
        cpp = BUILD_DIR / f"{tag}.{src.stem}.cpp"
        cpp.write_text(translate(src.read_text()))
        cpps.append(cpp)
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, f"-I{EMU_DIR}", f"-I{_build._PKG / 'csrc'}",
         "-o", str(tmp), *map(str, cpps), str(CHECKS)], capture_output=True,
        text=True)
    for cpp in cpps:
        cpp.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The emulated kernels' library, entry points declared as
    :data:`mcqueens_torch.kernels._build.ENTRY_POINTS` declares them."""
    lib = ctypes.CDLL(str(build()))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = _build.ENTRY_POINTS[name]
        fn.restype = ctypes.c_int
    return lib
