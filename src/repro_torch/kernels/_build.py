"""Build and load the port's CUDA kernels (nvcc into a shared library,
bound with ctypes).

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into
one ``.so`` under ``<checkout>/build/kernels/``, named by a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
reused.  A lock file serialises concurrent builds (several worker
processes, or several tests), and the library is moved into place only
once it is complete.

``build_library`` runs ``nvcc`` and nothing else: it makes no CUDA call,
so a process may call it and still fork workers that use the card.
``load_library`` opens the library with ctypes and declares the C
functions; the wrappers in ``repro_torch.kernels`` call it at their first
launch, never at import.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/src/repro_torch/kernels/_build.py -> <checkout>/build/kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the kernels if no library for these sources exists yet.

    Returns the library's path.  Runs ``nvcc`` only; makes no CUDA call.
    The compiler's report (registers, shared memory, spills per kernel)
    is kept beside the library as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():                       # built by another process
            return lib
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lib.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, open the library and declare its C functions."""
    lib = ctypes.CDLL(str(build_library()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pda_launch.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp,
                               ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
    lib.pda_launch.restype = ci
    lib.pda_smem_bytes.argtypes = [ci, ci, ci]
    lib.pda_smem_bytes.restype = ctypes.c_size_t
    return lib
