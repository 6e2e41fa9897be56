"""The dry-run driver's calibration step, measured on the card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --emit-devmodel \
      --arch qwen2-0.5b [--out DIR] [--device cuda|cpu]

The twin of ``repro.launch.dryrun.emit_devmodel``.  The reference reads
the TPU dry-run artifacts of a prefill cell and a decode cell, takes each
cell's roofline-bound step seconds and turns them into the
``DeviceModel`` coefficients that the emulated backend (``serve
--devmodel``) and the DES consume.  Here the same two cells are timed on
the card instead: ``Model`` at the arch's published widths, weights drawn
from a seeded ``torch.Generator`` (nothing is downloaded), one
``Model.prefill`` over the prefill cell's tokens and one ``decode_step``
over a cache of the decode cell's length filled from the generator.  A
batch that does not fit the card's memory is halved until it does, and
the record says so.  Each time is the median of ``REPEATS`` calls after a
warm-up call, by CUDA events on the card and by ``time.perf_counter`` on
the CPU.  ``DeviceModel.from_roofline`` turns the seconds into
coefficients exactly as the reference turns its bounds into them.

The rest of the reference's driver (lowering and compiling every cell on
a 256-device mesh) is not ported: its flags exit with "not yet ported".
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple, Union

import torch

from repro_torch.configs import CELLS_BY_NAME, ModelConfig, ShapeCell, get_config
from repro_torch.core.devmodel import DeviceModel
from repro_torch.device import resolve_device
from repro_torch.models import model as M

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"
REPEATS = 3
_NOT_PORTED = ("--cell", "--all", "--multi-pod", "--both-meshes", "--unroll")


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
    ap.add_argument("--emit-devmodel", action="store_true",
                    help="time this arch's prefill/decode cells on the "
                         "device and emit the EmulatedBackend calibration")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the cells are timed (the card by default)")
    ap.add_argument("--cell", default=None)
    for flag in _NOT_PORTED[1:]:
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)
    given = [f for f in _NOT_PORTED
             if getattr(args, f[2:].replace("-", "_")) not in (None, False)]
    if given or not args.emit_devmodel:
        sys.exit(f"not yet ported: the dry-run compile driver "
                 f"({' '.join(given) or 'without --emit-devmodel'}); only "
                 f"--emit-devmodel runs")
    if not args.arch:
        ap.error("--emit-devmodel requires --arch")
    emit_devmodel(args.arch, Path(args.out),
                  device="cpu" if args.device == "cpu" else None)


if __name__ == "__main__":
    main()
