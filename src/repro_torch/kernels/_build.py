"""Build and load the port's CUDA kernels (nvcc into a shared library,
bound with ctypes).

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together) and linked into one ``.so``
under ``<checkout>/build/kernels/``, named by a hash of the sources (the
``*.cuh`` headers included) and flags, so an edited source builds anew and
an unchanged one is reused.  A lock file serialises concurrent builds
(several worker processes, or several tests), and the library is moved
into place only once it is complete.

``build_library`` runs ``nvcc`` and nothing else: it makes no CUDA call,
so a process may call it and still fork workers that use the card.
``load_library`` opens the library with ctypes and declares the C
functions; the wrappers in ``repro_torch.kernels`` call it at their first
launch, never at import.  ``checked_once`` and ``launch`` keep a
wrapper's host work per call short: checks run once per call signature,
and a launch enters a device context only when it must.
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
from typing import Callable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/src/repro_torch/kernels/_build.py -> <checkout>/build/kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    for src in sorted(CSRC.glob("*.cu*")):          # sources and headers
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
        nvcc = _nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(_sources(), objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        outs = [p.communicate()[0] for p in procs]
        rcs = [p.returncode for p in procs]
        if not any(rcs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            outs.append(link.stdout + link.stderr)
            rcs.append(link.returncode)
        for o in objs:
            o.unlink(missing_ok=True)
        lib.with_suffix(".log").write_text("".join(
            " ".join(c) + "\n" + out for c, out in zip(cmds, outs)))
        if any(rcs):
            bad = next(i for i, rc in enumerate(rcs) if rc)
            raise RuntimeError(f"nvcc failed ({rcs[bad]}): "
                               f"{' '.join(cmds[bad])}\n{outs[bad][-4000:]}")
        os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, open the library and declare its C functions."""
    lib = ctypes.CDLL(str(build_library()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pda_launch.argtypes = [ci, *[vp] * 10, *[ci] * 8, ctypes.c_float,
                               vp]
    lib.pda_launch.restype = ci
    lib.pda_blocks_per_sm.argtypes = [ci, ci, ci]
    lib.pda_blocks_per_sm.restype = ci
    lib.pda_smem_bytes.argtypes = [ci, ci, ci]
    lib.pda_smem_bytes.restype = ctypes.c_size_t
    i64 = ctypes.c_int64
    lib.fa_launch.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                              *[i64] * 12, ci, ci, ctypes.c_float, vp, vp]
    lib.fa_launch.restype = ci
    lib.fa_wgmma_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                    *[i64] * 12, ci, ci, ctypes.c_float, vp,
                                    vp]
    lib.fa_wgmma_launch.restype = ci
    lib.fab_launch.argtypes = [ci, *[vp] * 10, ci, ci, ci, ci, ci,
                               ctypes.POINTER(i64), ci, ci, ctypes.c_float,
                               vp]
    lib.fab_launch.restype = ci
    lib.fab_wgmma_launch.argtypes = [*[vp] * 10, ci, ci, ci, ci, ci,
                                     ctypes.POINTER(i64), ci, ci,
                                     ctypes.c_float, ctypes.c_float, vp]
    lib.fab_wgmma_launch.restype = ci
    lib.fab_wgmma_rows.argtypes = [ci]
    lib.fab_wgmma_rows.restype = ci
    lib.da_launch.argtypes = [ci, *[vp] * 9, ci, ci, ci, ci, ci, ci,
                              *[i64] * 10, ci, ctypes.c_float, vp]
    lib.da_launch.restype = ci
    lib.da_tile_slots.argtypes = [ci, ci]
    lib.da_tile_slots.restype = ci
    lib.ms_launch.argtypes = [*[vp] * 9, ci, ci, ci, ci, *[i64] * 4, vp]
    lib.ms_launch.restype = ci
    lib.ms_ckpt_steps.argtypes = []
    lib.ms_ckpt_steps.restype = ci
    lib.msb_launch.argtypes = [*[vp] * 15, ci, ci, ci, ci, vp]
    lib.msb_launch.restype = ci
    lib.msb_blocks.argtypes = [ci, ci]
    lib.msb_blocks.restype = ci
    lib.moe_dispatch_launch.argtypes = [*[vp] * 6, *[ci] * 7, vp]
    lib.moe_dispatch_launch.restype = ci
    lib.moe_combine_launch.argtypes = [ci, *[vp] * 4, ci, ci, ci, vp]
    lib.moe_combine_launch.restype = ci
    lib.moe_limits.argtypes = [ci]
    lib.moe_limits.restype = ci
    lib.moe_routed_dispatch_launch.argtypes = [*[vp] * 7, *[ci] * 7, vp]
    lib.moe_routed_dispatch_launch.restype = ci
    lib.moe_routed_combine_launch.argtypes = [ci, *[vp] * 4, ci, ci, ci, vp]
    lib.moe_routed_combine_launch.restype = ci
    lib.moe_routed_workspace_bytes.argtypes = [ci, ci, ci]
    lib.moe_routed_workspace_bytes.restype = ctypes.c_size_t
    lib.moe_routed_limits.argtypes = [ci]
    lib.moe_routed_limits.restype = ci
    lib.ssd_launch.argtypes = [*[vp] * 11, *[ci] * 5, *[i64] * 6, vp]
    lib.ssd_launch.restype = ci
    lib.ssd_limits.argtypes = [ci]
    lib.ssd_limits.restype = ci
    return lib


_MAX_SIGNATURES = 256       # per cache; past it the cache starts anew


def checked_once(cache: dict, check, *tensors):
    """``check()`` once per call signature of ``tensors`` (shape, strides,
    dtype and device of each; None and ints stay as they are): the first
    call with a signature runs it, and raises as it does; a later one
    returns the value it cached.  ``check`` must read nothing of the
    tensors but their signature, and return something other than None."""
    key = tuple(t if t is None or isinstance(t, int) else
                (t.shape, t.stride(), t.dtype, t.device) for t in tensors)
    value = cache.get(key)
    if value is None:
        value = check()
        if len(cache) >= _MAX_SIGNATURES:
            cache.clear()
        cache[key] = value
    return value


def launch(index: int, fn, *args) -> int:
    """Call the C launcher ``fn(*args, stream)`` on the current stream of
    card ``index``, inside a device context only when ``index`` is not the
    current device; returns its cudaError_t."""
    import torch
    if index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(index).cuda_stream)
    with torch.cuda.device(index):
        return fn(*args, torch.cuda.current_stream(index).cuda_stream)


# -- the registries kernels._graph reads ---------------------------------------

COUNTED: list = []


def counted(wrapper: Callable) -> Callable:
    """Register ``wrapper``, which adds one to its ``launches`` (and, where
    it has one, to its route's entry in ``launches_by_route``) where it
    launches its kernel, and start its count at 0."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


def launch_counts() -> list:
    """Each registered wrapper's ``launches`` and a copy of its
    ``launches_by_route`` ({} where it has none), in ``COUNTED``'s order."""
    return [(w.launches, dict(getattr(w, "launches_by_route", {})))
            for w in COUNTED]


SCRATCH: dict = {}      # (owner, device index) -> (split counters, partials)


def split_scratch(owner: str, device, n_counters: int, n_part: int) -> tuple:
    """``owner``'s split counters on ``device`` (at least ``n_counters``
    int32, zeroed once when made and left at zero by every launch, whose
    last block of each group resets its entry) and partials (at least
    ``n_part`` float32), each replaced by a larger one when a call needs
    more.  Calls on one device share them, so they must not run
    concurrently on two streams.  A captured graph keeps the ones in use at
    its capture (``kernels._graph``)."""
    import torch
    counters, part = SCRATCH.get((owner, device.index), (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 1024), dtype=torch.int32,
                               device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1 << 16), dtype=torch.float32,
                           device=device)
    SCRATCH[owner, device.index] = counters, part
    return counters, part


# -- the dry-run's trace: kernels on meta tensors ------------------------------

META_SINKS: list = []


def on_meta(flops: int, nbytes: int) -> None:
    """Book one kernel call that a wrapper made on ``meta`` tensors, where
    nothing runs (the dry-run's trace): the operations the kernel does and
    the bytes it must move, each input read once and each output written
    once, to every sink in ``META_SINKS`` (``launch.dryrun.LocalCost``)."""
    for sink in META_SINKS:
        sink(flops, nbytes)
