#!/usr/bin/env python3
"""Time B3 (flash attention), B2 (decode attention), B1 (paged decode
attention) and B4 (the Mamba-1 scan) on the card, or their backward
kernels.

    python tools/attention_times.py [--root CHECKOUT] [--tag NAME] [--splits]
    python tools/attention_times.py --backward [--root CHECKOUT] [--tag NAME]

Runs the port's kernels from the checkout at CHECKOUT (default: this one)
at ``chip_smoke.py``'s shapes: B3 and B2 at phase 10's, bf16; B1 at phase
6's (64 and 8 rows of 32 full pages, qwen2-0.5b's heads, fp32 and int8);
B4 at phase 15's (falcon-mamba-7b's prefill, 8 x 512 from zero, and one
decode step, 8 x 1 from a state).  It prints for each the time per call
by CUDA events over 20 back-to-back calls (the wrapper's host work
between launches included) and the device time per call from
``torch.profiler`` (left out), with the largest error against the plain
version.  Both times come from this checkout's ``chip_smoke.py``
(``cuda_ms`` and ``_device_ms_per_call``), whatever CHECKOUT is, so that
two checkouts are timed alike.  ``--splits`` also times B2 at forced
split counts (``None`` is the wrapper's rule; CHECKOUT must have the
split kernel).  To compare two checkouts, unpack one beside the other
(``git archive``) and run both, in turns, on one card.  Needs a CUDA
device; the CHECKOUT's ``tests/test_torch_attention_cuda.py`` and
``tests/test_torch_mamba_scan_cuda.py`` build the inputs of B3, B2 and B4,
this checkout's ``chip_smoke.serving_case`` those of B1.

``--backward`` times only the backward kernels, at ``chip_smoke.py``'s
phase 32 shapes: B3's (bf16) at qwen2-0.5b's training call (8 x 512,
14/2 heads, D 64, causal) and at whisper-small's encoder (8 x 1,500,
12/12, bidirectional), with the CHECKOUT's forward kernel's output and
log-sum-exp and a grad_output laid out as the model's; B4's (float32) at
falcon-mamba-7b's training call (8 x 512 x 8,192 x 16, no initial state,
no h_last gradient), as ``MambaScanFn`` makes it: from the checkpoints
its forward pass keeps where the CHECKOUT's ``mamba1_scan`` writes them
(``with_checkpoints``), and the forward pass is timed beside it, so that
the two passes together compare across checkouts.  Each kernel is first
held to its plain version on the timed inputs.  The CHECKOUT's
``tests/test_torch_attention_cuda.py`` and ``tests/test_torch_train_cuda.py``
build the inputs.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FLASH_SHAPES = ((8, 512, 14, 2, 64), (1, 4096, 14, 2, 64),
                (8, 512, 32, 32, 64), (8, 512, 16, 16, 128))
DECODE_SHAPES = ((64, 4096), (8, 544))
PAGED_ROWS = (64, 8)
SCAN_SHAPES = ((512, False), (1, True))
SPLIT_SHAPES = {(64, 4096): (None, 1, 2, 3, 9, 16),
                (8, 544): (None, 1, 3, 9),
                (1, 8192): (None, 16, 64, 128)}
# (B, S, H, KV, D, causal): qwen2-0.5b's training call, whisper's encoder
BWD_SHAPES = ((8, 512, 14, 2, 64, True), (8, 1500, 12, 12, 64, False))


def _smoke():
    """This checkout's chip_smoke.py, for its timing helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--backward", action="store_true")
    args = ap.parse_args()
    smoke = _smoke()
    sys.path[:0] = [str(args.root / "src"), str(args.root / "tests")]
    import torch
    if args.backward:
        return backward(smoke, torch, f"[{args.tag}] " if args.tag else "")

    import test_torch_attention_cuda as cases
    from repro_torch.kernels.decode_attention import (
        decode_attention_bhd, decode_attention_reference)
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd, flash_attention_reference)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev, tag = torch.device("cuda"), f"[{args.tag}] " if args.tag else ""

    def report(what, fn, plain):
        err = (fn().float() - plain().float()).abs().max().item()
        print(f"{tag}{what}: events {smoke.cuda_ms(fn):.4f} ms, device "
              f"{smoke._device_ms_per_call(fn)}, max abs err {err:.3g}",
              flush=True)

    for B, S, H, KV, D in FLASH_SHAPES:
        c = cases.model_flash(dev, torch.bfloat16, B=B, S=S, H=H, KV=KV, D=D)
        report(f"B3 B{B} S{S} H{H} KV{KV} D{D}",
               lambda: cases.run_flash(flash_attention_bhsd, c),
               lambda: cases.run_flash(flash_attention_reference, c))
    shapes = SPLIT_SHAPES if args.splits else {s: (None,)
                                               for s in DECODE_SHAPES}
    for (B, Sc), splits in shapes.items():
        c = cases.model_decode(dev, torch.bfloat16, B=B, Sc=Sc)
        c["cache_len"] = torch.full((B,), Sc, dtype=torch.int32, device=dev)
        for n in splits:
            def fn(n=n):
                return (cases.run_decode(decode_attention_bhd, c) if n is None
                        else cases.run_decode_splits(c, n))
            report(f"B2 B{B} S{Sc}" + (f" splits {n}" if args.splits else ""),
                   fn, lambda: cases.run_decode(decode_attention_reference, c))

    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_reference)
    for rows in PAGED_ROWS:
        for quantized in (False, True):
            pa, kw = smoke.to_device(smoke.serving_case(
                quantized, dev, ragged=False, rows=rows), dev)
            report(f"B1 {'int8' if quantized else 'fp32'} B{rows} pages 32",
                   lambda: paged_decode_attention(*pa, **kw),
                   lambda: paged_decode_attention_reference(*pa, **kw))

    import test_torch_mamba_scan_cuda as scan_cases
    from repro_torch.kernels.mamba_scan import (
        mamba1_scan, mamba1_scan_reference)
    for T, with_h0 in SCAN_SHAPES:
        c = scan_cases.falcon_case(dev, T, with_h0=with_h0, seed=1)
        report(f"B4 B8 T{T} Di8192 N16" + (" from h0" if with_h0 else ""),
               lambda: scan_cases.run(mamba1_scan, c)[0],
               lambda: scan_cases.run(mamba1_scan_reference, c)[0])


def _by_kernel(torch, fn, calls: int = 20) -> str:
    """Device ms per call of each kernel ``fn`` launches, from
    ``torch.profiler``."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            m = re.search(r"(\w+_kernel)\b", e.key)
            parts.append(f"{m.group(1) if m else e.key[:40]} "
                         f"{e.self_device_time_total / calls / 1e3:.4f}")
    return "; ".join(parts) or "not measured"


def backward(smoke, torch, tag: str) -> None:
    """``--backward``: B3's and B4's backward kernels of the CHECKOUT."""
    import inspect

    import test_torch_train_cuda as cases
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd, flash_attention_bwd,
        flash_attention_bwd_reference)
    from repro_torch.kernels.mamba_scan import (
        mamba1_scan, mamba1_scan_bwd, mamba1_scan_bwd_reference,
        mamba1_scan_reference)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")

    def report(what, fn, plain):
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(fn(), plain()))
        print(f"{tag}{what}: events {smoke.cuda_ms(fn):.4f} ms, device "
              f"{smoke._device_ms_per_call(fn)} ({_by_kernel(torch, fn)}), "
              f"max abs err {err:.3g}", flush=True)

    for B, S, H, KV, D, causal in BWD_SHAPES:
        c = cases.attn_cases.model_flash(dev, torch.bfloat16, B=B, S=S, H=H,
                                         KV=KV, D=D)
        q, k, v = c["q"], c["k"], c["v"]
        do = torch.randn((B, S, H, D), generator=torch.Generator(
            dev).manual_seed(2), device=dev).to(torch.bfloat16).transpose(
                1, 2)
        o, lse = flash_attention_bhsd(q, k, v, causal=causal, with_lse=True)
        report(f"B3-bwd B{B} S{S} H{H} KV{KV} D{D} "
               + ("causal" if causal else "bidirectional"),
               lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal),
               lambda: flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                     causal))
        del c, q, k, v, do, o, lse

    c = cases.scan_bwd_case(cases.scan_cases.falcon_case(dev, 512,
                                                         with_h0=False), dev)
    args = [c[n] for n in ("x", "dt", "Bt", "Ct", "A")]
    kept = "with_checkpoints" in inspect.signature(mamba1_scan).parameters
    extra = {"with_checkpoints": True} if kept else {}
    ckpt = (mamba1_scan(*args, **extra)[2],) if kept else ()
    what = ("from the forward's checkpoints" if kept
            else "its own forward sweep included")
    report(f"B4-bwd B8 T512 Di8192 N16 ({what})",
           lambda: mamba1_scan_bwd(*args, None, c["dy"], None, *ckpt)[:5],
           lambda: mamba1_scan_bwd_reference(*args, None, c["dy"],
                                             None)[:5])
    report("B4 forward as training calls it"
           + (" (with checkpoints)" if kept else ""),
           lambda: mamba1_scan(*args, **extra)[:1],
           lambda: mamba1_scan_reference(*args)[:1])


if __name__ == "__main__":
    main()
