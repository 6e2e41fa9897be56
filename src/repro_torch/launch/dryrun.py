"""The dry-run driver: the port of ``src/repro/launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--unroll]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --emit-devmodel --arch qwen2-0.5b [--device cpu]

For every (architecture x shape cell x mesh) it builds the real step
(``build_step``: the ZeRO-1 train step, prefill, or one decode step) on
the production mesh (``pod_16x16`` or ``multipod_2x16x16``), proving that
the placements are coherent, and writes one JSON record per cell to
``artifacts/dryrun/`` (gitignored) with the reference's file names and
keys: FLOPs and bytes a device, the collectives, memory, and the roofline
terms on the H100 (``repro_torch.roofline``).

Where the reference lowers and compiles with XLA, "compile" here is a
trace.  The model is built on the ``meta`` device (shapes, no storage),
its parameters placed as DTensors on a ``DeviceMesh`` over torch's fake
process group (``launch.mesh.fake_world``: one process is rank 0 of 512,
and the collectives move nothing), and the step runs once on rank 0's
shards under two dispatch modes that see its local ops:

* ``LocalCost``: FLOPs of the matrix products (``torch.utils.
  flop_counter``'s table, on local shapes), bytes (each op's tensor
  operands and results, op by op: an unfused upper bound, as XLA:CPU's
  ``bytes accessed`` is), and the eager peak of the local storage the
  step allocates, each storage counted until it is freed.  The memory
  fields are that eager peak (arguments = the local shards of the
  parameters, optimizer state, cache and batch; temp = the peak of what
  the step allocates on top), not XLA's ``memory_analysis``.  (torch's
  ``MemTracker`` refuses a module that one step calls twice at the top
  level, as zamba2's shared block and every module over microbatches
  are, so this module keeps the count itself.)
* ``roofline.collectives.CollectiveCounter``: each collective's operand
  bytes and count.

On ``meta`` the kernel wrappers (B2, B3, B4 and the backward kernels)
run nothing: each returns empty results of its kernel's shapes and books
its kernel's analytic operations and bytes (``kernels._build.on_meta``),
which ``LocalCost`` adds to the step's, so the FLOPs, bytes and peak are
those of the port's kernel path, not of the plain versions.  (The
reference's dry-run runs ``repro.kernels.ref`` on host devices.)  Eager
tracing
runs every period, so the full-depth trace counts the whole depth, and
``depth_extrapolate`` (kept, with its record field) equals it for archs
with whole periods.  ``emit_devmodel`` is the calibration step, measured
on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import platform
import statistics
import subprocess
import time
import traceback
import weakref
from pathlib import Path
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (
    ARCHS,
    CELLS_BY_NAME,
    ModelConfig,
    ShapeCell,
    cell_applicable,
    get_config,
    input_specs,
)
from repro_torch.core.devmodel import DeviceModel
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import TP_AXIS, place, spec_for, use_mesh
from repro_torch.kernels._build import META_SINKS
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model as M
from repro_torch.roofline import (
    H100_SXM,
    CollectiveCounter,
    collective_bytes,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline.model import model_bytes_per_device
from repro_torch.train import optim
from repro_torch.train import step as train_step_mod

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"
REPEATS = 3
MESH_NAMES = {False: "pod_16x16", True: "multipod_2x16x16"}
WORLD = 512             # one fake world holds both production meshes


def _batch_shardings(cfg, cell, specs):
    """The spec of each input-batch leaf (the reference's NamedShardings)."""
    def sh(name, leaf):
        if name == "mrope_positions":           # [3, B, S]
            axes = (None, "dp", None)
        elif name == "frames":                  # [B, T, d]
            axes = ("dp", None, None)
        elif name == "cache_len":
            axes = ()
        else:                                    # tokens/targets [B, S]
            axes = ("dp", None)
        axes = axes[: len(leaf.shape)]
        return spec_for(leaf.shape, *axes)

    return {k: sh(k, v) for k, v in specs.items()}


def _place_all(tree, shardings):
    """Each tensor placed by its spec; a replicated one stays a plain
    tensor (the model takes plain tensors as replicated)."""
    return {k: v if all(e is None for e in shardings[k])
            else place(v, shardings[k]) for k, v in tree.items()}


def build_step(cfg, cell, *, unroll: bool = False, ce_chunks: int = 8,
               remat: bool = True):
    """The step of ``cell`` for ``cfg`` on the active mesh, ready to run:
    returns (fn, args, shardings), ``fn(*args)`` running it once.  The
    model is built on ``meta`` (shapes only) and placed by
    ``param_shardings``; the inputs are ``input_specs``' tensors placed by
    ``_batch_shardings``; a train cell's optimizer state lies in the
    ZeRO-1 layout (``zero1_shardings``), a decode cell's cache in
    ``cache_shardings``'.  ``shardings`` holds those spec trees
    (reference-keyed)."""
    shapes = M.param_shapes(cfg)
    p_shard = M.param_shardings(cfg, shapes)
    model = M.place_params(M.Model(cfg, device="meta"), p_shard)
    specs = input_specs(cfg, cell)
    b_shard = _batch_shardings(cfg, cell, specs)
    batch = _place_all(specs, b_shard)
    extras = {k: v for k, v in batch.items()
              if k not in ("tokens", "targets", "cache_len")}

    if cell.kind == "train":
        zero1 = optim.zero1_shardings(p_shard, shapes)
        params = dict(model.named_parameters())
        opt = optim.init_opt_state(params, M.port_specs(model, zero1))
        n_micro = train_step_mod.pick_n_micro(cfg, cell.global_batch,
                                              cell.seq_len)
        step = train_step_mod.make_train_step(
            model, optim.AdamWConfig(), n_micro=n_micro, unroll=unroll,
            remat=remat, ce_chunks=ce_chunks, grad_shardings=zero1,
            param_shardings=p_shard)
        return step, (opt, batch), {"params": p_shard, "opt": zero1,
                                    "batch": b_shard, "model": model}

    if cell.kind == "prefill":
        return (lambda toks, ex: model.prefill(toks, ex),
                (batch["tokens"], extras),
                {"params": p_shard, "batch": b_shard, "model": model})

    cache_shape = M.cache_specs(cfg, cell.global_batch, cell.seq_len)
    c_shard = M.cache_shardings(cfg, cache_shape)
    cache = M.place_tree(cache_shape, c_shard)
    return (lambda toks, c, clen, ex: model.decode_step(toks, c, clen, ex),
            (batch["tokens"], cache, batch["cache_len"], extras),
            {"params": p_shard, "cache": c_shard, "batch": b_shard,
             "model": model})


class LocalCost(TorchDispatchMode):
    """What one rank's step costs, from the local ops it dispatches
    on ``device`` (DTensor ops are let through, so that their local ops
    come back here; DTensor's own work, its shape propagation on fake
    tensors and its mesh arithmetic on the CPU, is left out):

    * ``flops``: the ops in ``torch.utils.flop_counter``'s table (matrix
      products, convolutions, attention), on local shapes, and each
      kernel's operations as its wrapper books them on ``meta``;
    * ``bytes``: every non-view op's tensor operands and results (an
      allocation moves none), and each kernel's bytes as booked;
    * ``peak``: the peak of live storage that the step allocates, each new
      storage counted until it is freed (a weak reference to it), on top
      of what was live before (``held``: the arguments)."""

    def __init__(self, device, held=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.device = torch.device(device)
        self.flops = self.bytes = self.live = self.peak = 0
        self._seen = set(held)

    def _kernel(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        META_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        META_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    def _free(self, key, n):
        self.live -= n
        self._seen.discard(key)

    def _allocated(self, out):
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _has_fake(args) or _has_fake(out) or not _on(out, self.device):
            return out          # DTensor's own work, not the step's
        packet = getattr(func, "_overloadpacket", None)
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = str(packet)
        if not getattr(func, "is_view", False) and "view" not in name \
                and "c10d" not in name and name not in _ALLOCATIONS:
            self.bytes += _tensor_bytes(args) + _tensor_bytes(
                kwargs.values()) + _tensor_bytes(out)
        self._allocated(out)
        return out


_ALLOCATIONS = {"aten.empty", "aten.empty_like", "aten.empty_strided",
                "aten.new_empty", "aten.new_empty_strided"}


def _on(x, device) -> bool:
    """Whether an op's result lies on the step's device (DTensor computes
    mesh coordinates with small CPU tensors of its own)."""
    if isinstance(x, (list, tuple)):
        return any(_on(t, device) for t in x) or not x
    return not isinstance(x, torch.Tensor) or x.device == device


def _has_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    if isinstance(x, (list, tuple)):
        return any(_has_fake(t) for t in x)
    return isinstance(x, FakeTensor)


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)) or type(x).__name__ == "dict_values":
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _local_leaves(tree):
    """This rank's shards of the tensors in a nested structure."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _local_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _local_leaves(v)
    elif isinstance(tree, torch.nn.Module):
        for p in tree.parameters():
            yield from _local_leaves(p)


def _local_bytes(tree, skip=()) -> int:
    return sum(t.numel() * t.element_size() for t in _local_leaves(tree)
               if t.untyped_storage()._cdata not in skip)


def trace(fn, args, model) -> dict:
    """Run ``fn(*args)`` once under ``LocalCost`` and
    ``CollectiveCounter``; returns their per-device numbers: FLOPs, bytes,
    the collectives, and memory (arguments: the local shards of the
    parameters and of ``args``; outputs: those of the results, less what
    aliases the arguments, counted as ``alias``; temp: the traced peak of
    what the step allocates)."""
    leaves = list(_local_leaves((model, args)))
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves)
    held = {t.untyped_storage()._cdata for t in leaves}
    counter = CollectiveCounter()
    cost = LocalCost(next(iter(model.parameters())).device, held)
    t0 = time.time()
    # the backward pass on this thread, where the modes are (autograd
    # may run a device's backward on a thread of its own)
    with torch.autograd.set_multithreading_enabled(False), counter, cost:
        out = fn(*args)
    seconds = time.time() - t0
    out_all = _local_bytes(out)
    out_new = _local_bytes(out, skip=held)
    return {"flops": float(cost.flops), "bytes": float(cost.bytes),
            "collectives": collective_bytes(counter),
            "comm_counts": {str(k): int(v) for k, v in
                            counter.get_comm_counts().items()},
            "memory": {"argument_size_in_bytes": int(arg_bytes),
                       "output_size_in_bytes": int(out_new),
                       "alias_size_in_bytes": int(out_all - out_new),
                       "temp_size_in_bytes": int(cost.peak),
                       "peak_size_in_bytes": int(arg_bytes + cost.peak)},
            "seconds": seconds}


def warm_up(cfg, cell) -> None:
    """Run the step once, uncounted, at two periods' depth.  The first time
    DTensor meets an op signature it works out a sharding for it, for some
    ops (softplus's backward, ...) by running their decomposition on the
    step's own tensors, which a trace would count as the step's work.  Two
    periods hold every signature a deeper stack has (a period under
    another, a period on top), so the traces after this count the step
    alone, at any depth."""
    fn, args, _ = build_step(_reduced_depth_cfg(cfg, 2), cell)
    fn(*args)


def _reduced_depth_cfg(cfg, n_periods: int):
    """Same-period-structure config with ``n_periods`` periods per stage."""
    over = {}
    if cfg.local_global_ratio is not None:
        over["n_layers"] = sum(cfg.local_global_ratio) * n_periods
    elif cfg.family == "hybrid":
        over["n_layers"] = (cfg.hybrid_period or 6) * n_periods
    elif cfg.encdec is not None:
        over["n_layers"] = n_periods
        over["encdec"] = dataclasses.replace(cfg.encdec,
                                             n_encoder_layers=n_periods)
    else:
        over["n_layers"] = n_periods
    return cfg.scaled(**over)


def _periods_total(cfg) -> float:
    if cfg.local_global_ratio is not None:
        return cfg.n_layers / sum(cfg.local_global_ratio)
    if cfg.family == "hybrid":
        return cfg.n_layers / (cfg.hybrid_period or 6)
    return float(cfg.n_layers)


def _measure(cfg, cell, *, unroll: bool):
    """Trace one step; return (flops, bytes, coll_bytes, coll_count) a
    device.  The trace runs every microbatch, so unlike the reference's
    compile (whose grad-accumulation scan body counts once) nothing is
    scaled by ``n_micro``."""
    fn, args, sh = build_step(cfg, cell, unroll=unroll)
    t = trace(fn, args, sh["model"])
    c = t["collectives"]
    return t["flops"], t["bytes"], float(c["total_bytes_h100"]), int(
        c["total_count"])


def depth_extrapolate(cfg, cell):
    """Per-device numbers for the full depth from two shallow traces:
    X_total = X1 + (P-1) * (X2 - X1), the reference's formula.  The
    reference needs it because XLA's cost analysis counts a scan body
    once; an eager trace counts every period, so for whole periods this
    equals the full-depth trace (zamba2's fractional tail period is
    approximated, as in the reference)."""
    f1, b1, cb1, cc1 = _measure(_reduced_depth_cfg(cfg, 1), cell,
                                unroll=True)
    f2, b2, cb2, cc2 = _measure(_reduced_depth_cfg(cfg, 2), cell,
                                unroll=True)
    p = _periods_total(cfg)
    return {
        "flops": f1 + (p - 1) * (f2 - f1),
        "bytes": b1 + (p - 1) * (b2 - b1),
        "coll_bytes_h100": cb1 + (p - 1) * (cb2 - cb1),
        "coll_count": cc1 + (p - 1) * (cc2 - cc1),
        "per_period": {"flops": f2 - f1, "bytes": b2 - b1,
                       "coll_bytes_h100": cb2 - cb1},
        "base": {"flops": f1, "bytes": b1, "coll_bytes_h100": cb1},
        "n_periods": p,
    }


def trace_mesh(mesh):
    """The mesh a step is traced on: ``mesh`` itself, or, when it has more
    than one data axis (``multipod_2x16x16``'s "pod" and "data"), the same
    ranks with those axes flattened into one "data" axis.  Every spec of
    the model names the data axes together (the logical "dp"), so the two
    lay every tensor out alike; on the flattened mesh a reduction over
    them is one collective, as XLA's over both axes is, where DTensor on
    the 3-D mesh issues one per axis, and its sharding propagation, which
    costs seconds per matrix product in the backward pass on a 3-D mesh,
    stays cheap."""
    from torch.distributed.device_mesh import DeviceMesh
    names = tuple(mesh.mesh_dim_names)
    if len(names) <= 2:
        return mesh
    if names[-1] != TP_AXIS:
        raise ValueError(f"the tensor axis must be the last: {names}")
    ranks = mesh.mesh.reshape(-1, mesh.mesh.shape[-1])
    return DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("data", TP_AXIS))


def run_cell(arch: str, cell_name: str, *, multi_pod: bool = False,
             unroll: bool = False, out_dir: Path = ARTIFACTS,
             verbose: bool = True, extrapolate: bool = True,
             config: Optional[ModelConfig] = None, mesh=None,
             mesh_name: Optional[str] = None) -> dict:
    """One (arch, cell, mesh) record, written to ``out_dir`` and returned.
    ``config`` overrides the arch's published config and ``mesh`` (with
    ``mesh_name``) the production mesh, for the tests' small cases; a
    process group is initialised when there is none (``fake_world``)."""
    cfg = config or get_config(arch)
    cell = CELLS_BY_NAME[cell_name] if isinstance(cell_name, str) \
        else cell_name
    cell_name = cell.name
    ok, reason = cell_applicable(cfg, cell)
    mesh_name = mesh_name or MESH_NAMES[multi_pod]
    rec = {"arch": arch, "cell": cell_name, "mesh": mesh_name,
           "status": "skip", "reason": reason}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = out_dir / f"{mesh_name}__{arch}__{cell_name}.json"
    if not ok:
        fname.write_text(json.dumps(rec, indent=1))
        return rec

    with fake_world(WORLD):
        mesh = mesh if mesh is not None else make_production_mesh(
            multi_pod=multi_pod)
        n_dev = mesh.size()
        with use_mesh(trace_mesh(mesh)) as ctx:
            t0 = time.time()
            warm_up(cfg, cell)
            fn, args, sh = build_step(cfg, cell, unroll=unroll)
            t_lower = time.time() - t0
            traced = trace(fn, args, sh["model"])
            del fn, args, sh
            ext = (depth_extrapolate(cfg, cell)
                   if extrapolate and not multi_pod else None)
            tp, dp = ctx.tp, ctx.dp
    colls = traced["collectives"]
    flops_dev, bytes_dev = traced["flops"], traced["bytes"]
    if ext is not None:
        flops_r, bytes_r, coll_r = (ext["flops"], ext["bytes"],
                                    ext["coll_bytes_h100"])
    else:
        flops_r, bytes_r = flops_dev, bytes_dev
        coll_r = float(colls["total_bytes_h100"])
    terms = roofline_terms(flops_r, bytes_r, coll_r, H100_SXM)
    mf = model_flops(cfg, cell)
    terms["model_flops_global"] = mf
    terms["traced_flops_global"] = flops_r * n_dev
    terms["useful_fraction"] = (mf / (flops_r * n_dev)
                                if flops_r else float("inf"))
    # the card's memory term: the analytic fused-traffic lower bound (the
    # traced bytes are an unfused upper bound; see roofline/model.py)
    nm = (train_step_mod.pick_n_micro(cfg, cell.global_batch, cell.seq_len)
          if cell.kind == "train" else 1)
    mb = model_bytes_per_device(cfg, cell, tp=tp, dp=dp, n_micro=nm)
    terms["memory_s_h100_est"] = mb / H100_SXM.hbm_bw
    card_terms = {"compute_s": terms["compute_s"],
                  "memory_s": terms["memory_s_h100_est"],
                  "collective_s": terms["collective_s"]}
    dom = max(card_terms, key=card_terms.get)
    terms["dominant_h100"] = dom
    useful_time = mf / (n_dev * H100_SXM.peak_flops)
    terms["roofline_fraction_h100"] = (
        useful_time / card_terms[dom] if card_terms[dom] > 0 else 0.0)
    terms["hardware"] = dataclasses.asdict(H100_SXM)
    terms["notes"] = (
        "hardware figures: NVIDIA H100 SXM datasheet, not measured; the "
        "16-wide 'model' axis spans two 8-GPU NVLink nodes, so collective_s "
        "(NVLink bandwidth throughout) is a lower bound")

    mem = traced["memory"]
    rec.update(
        status="ok",
        n_devices=int(n_dev),
        lower_s=round(t_lower, 2),         # the warm-up and the build
        compile_s=round(traced["seconds"], 2),
        compile="an eager trace of rank 0's step on meta tensors under a "
                "fake process group" + ("" if len(mesh.mesh_dim_names) <= 2
                                        else ", the data axes flattened "
                                        "into one (trace_mesh)"),
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        extrapolated=ext,
        collectives=colls,
        comm_counts=traced["comm_counts"],
        memory=mem,
        memory_note="eager peak of the traced step's local storage on the "
                    "kernel path (each kernel's outputs; the kernels' own "
                    "scratch is not counted), not XLA's memory_analysis",
        roofline=terms,
    )
    if verbose:
        live = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        print(f"[{mesh_name}] {arch} x {cell_name}: OK "
              f"trace={traced['seconds']:.1f}s flops/dev={flops_dev:.3e} "
              f"bytes/dev={bytes_dev:.3e} "
              f"coll={colls['total_bytes']:.3e}B/{colls['total_count']}ops "
              f"peak~{live / 1e9:.2f}GB dominant={dom} (H100)", flush=True)
        print(f"  memory: {mem}", flush=True)
    fname.write_text(json.dumps(rec, indent=1, default=float))
    return rec


def _cell(cell: Union[str, ShapeCell]) -> ShapeCell:
    return cell if isinstance(cell, ShapeCell) else CELLS_BY_NAME[cell]


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    the host's machine type for a CPU run."""
    if device.type != "cuda":
        return f"cpu ({platform.machine()})"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _median_seconds(fn: Callable[[], object], device: torch.device
                    ) -> Tuple[float, List[float]]:
    """Median seconds of ``REPEATS`` calls of ``fn`` after one warm-up
    call (the kernels' build, cuBLAS and the caching allocator)."""
    fn()
    times = []
    for _ in range(REPEATS):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def _fitting(run: Callable[[int], object], batch: int, what: str,
             cuts: List[str]):
    """``(b, run(b))`` for the cell's ``batch``, halved while the card runs
    out of memory; each halving is appended to ``cuts``."""
    b = batch
    while True:
        try:
            return b, run(b)
        except torch.OutOfMemoryError:
            if b == 1:
                raise
        # outside the handler, so that the failed call's tensors are freed
        cuts.append(f"{what} batch {b} -> {b // 2}: out of device memory")
        b //= 2
        torch.cuda.empty_cache()


def _extras(cfg: ModelConfig, b: int, positions: torch.Tensor,
            g: torch.Generator) -> dict:
    """What the stubbed frontends feed: whisper's encoder frames at
    prefill, qwen2-vl's M-RoPE positions (``positions`` [S])."""
    extras = {}
    if cfg.family == "vlm":
        extras["mrope_positions"] = positions.expand(3, b, -1)
    if cfg.family == "audio" and positions.numel() > 1:
        extras["frames"] = torch.randn(
            (b, cfg.encdec.n_encoder_ctx, cfg.d_model), generator=g,
            device=g.device).to(cfg.param_dtype())
    return extras


def emit_devmodel(arch: str, out_dir: Path = ARTIFACTS,
                  prefill_cell: Union[str, ShapeCell] = "prefill_32k",
                  decode_cell: Union[str, ShapeCell] = "decode_32k", *,
                  device=None, config: Optional[ModelConfig] = None) -> dict:
    """Time ``arch``'s prefill and decode cells on ``device`` (the card by
    default, raising without one; ``"cpu"`` only when asked), write
    ``devmodel__{arch}.json`` to ``out_dir`` and return its record: the
    reference's keys (``arch``, ``prefill_cell``, ``decode_cell``,
    ``device_model``) and ``measured_on`` (the device, the batches and
    lengths timed, every cut, the seconds).  ``config`` overrides the
    arch's published config (the CPU tests pass a tiny one)."""
    device = resolve_device(device)
    cfg = config or get_config(arch)
    pre, dec = _cell(prefill_cell), _cell(decode_cell)
    model = M.Model(cfg, generator=torch.Generator(device).manual_seed(0),
                    device=device)
    g = torch.Generator(device).manual_seed(1)
    cuts: List[str] = []

    def prefill(b):
        S = pre.seq_len
        toks = torch.randint(0, cfg.vocab_size, (b, S), generator=g,
                             device=device, dtype=torch.int32)
        extras = _extras(cfg, b, torch.arange(S, device=device), g)
        return _median_seconds(lambda: model.prefill(toks, extras), device)

    def decode(b):
        # a cache of the cell's length, every slot but the new token's
        # filled from the generator (no prefill of b x S tokens)
        S = dec.seq_len
        cache = {stage: {key: {n: torch.empty(
                     t.shape, dtype=t.dtype, device=device).normal_(
                         generator=g) for n, t in entry.items()}
                     for key, entry in layers.items()}
                 for stage, layers in M.cache_specs(cfg, b, S).items()}
        toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                             device=device, dtype=torch.int32)
        extras = _extras(cfg, b, torch.full((1,), S - 1, device=device), g)
        return _median_seconds(
            lambda: model.decode_step(toks, cache, S - 1, extras), device)

    pb, (prefill_s, prefill_runs) = _fitting(prefill, pre.global_batch,
                                             "prefill", cuts)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    db, (decode_s, decode_runs) = _fitting(decode, dec.global_batch,
                                           "decode", cuts)
    dm = DeviceModel.from_roofline(prefill_s, pb * pre.seq_len,
                                   decode_s, db)
    rec = {"arch": arch, "prefill_cell": pre.name,
           "decode_cell": dec.name, "device_model": dataclasses.asdict(dm),
           "measured_on": {
               "device": device_line(device), "dtype": str(cfg.dtype),
               "torch": torch.__version__,
               "prefill": {"batch": pb, "cell_batch": pre.global_batch,
                           "seq_len": pre.seq_len, "seconds": prefill_s,
                           "runs": prefill_runs},
               "decode": {"batch": db, "cell_batch": dec.global_batch,
                          "cache_len": dec.seq_len - 1, "seconds": decode_s,
                          "runs": decode_runs},
               "cuts": cuts}}
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"devmodel__{arch}.json"
    out.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] wrote {out}: {dm}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--unroll", action="store_true")
    ap.add_argument("--emit-devmodel", action="store_true",
                    help="time this arch's prefill/decode cells on the "
                         "device and emit the EmulatedBackend calibration")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where --emit-devmodel times the cells (the card "
                         "by default)")
    args = ap.parse_args(argv)

    if args.emit_devmodel:
        if not args.arch:
            ap.error("--emit-devmodel requires --arch")
        emit_devmodel(args.arch, Path(args.out),
                      device="cpu" if args.device == "cpu" else None)
        return

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [args.cell] if args.cell else list(CELLS_BY_NAME)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    if not (args.all or args.arch):
        ap.error("pass --arch/--cell or --all")

    failures = []
    for mp in meshes:
        for arch in archs:
            for cell in cells:
                try:
                    rec = run_cell(arch, cell, multi_pod=mp,
                                   unroll=args.unroll, out_dir=Path(args.out))
                    if rec["status"] == "skip":
                        print(f"[{'multipod' if mp else 'pod'}] {arch} x "
                              f"{cell}: SKIP ({rec['reason']})")
                except Exception as e:  # noqa: BLE001 - report all failures
                    traceback.print_exc()
                    failures.append((mp, arch, cell, repr(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-run cells OK")


if __name__ == "__main__":
    main()
