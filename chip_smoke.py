"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA H100 (or another sm_90a card), ``nvcc`` and this
checkout.  Phases, each of which fails the run (non-zero exit) when it
fails:

1. card: prints ``nvidia-smi``'s name and power limit;
2. build: compiles the port's CUDA kernels from ``src/repro_torch/csrc``;
3. serving: ``python -m repro_torch.launch.serve --backend torch --arch
   qwen2-0.5b --tp 2`` as a subprocess (fresh worker processes, so their
   launch counts start at 0), once in fp32 with ``--multi-step 4`` and
   once with ``--kv-dtype int8``; every request must complete and the
   workers' summed kernel launches must be above 0;
4. kernel vs plain version: the CUDA kernel against
   ``paged_decode_attention_reference`` on the same inputs on the card, at
   the serving shapes (H 14, KV 2, D 64, block 64, up to 64 rows of up to
   32 pages) and at the CPU tests' edge cases, fp32 and int8, atol = rtol
   = 1e-5;
5. token identity: ``TorchBackend`` on the card and on the CPU sample the
   same tokens on the conformance workload (k=1, and k=4 under swap
   churn);
6. times at the serving shapes with CUDA events: the kernel, the plain
   version, ``scaled_dot_product_attention`` over the gathered contiguous
   K/V as a yardstick (the port never calls it), and the bytes bound at
   3.35 TB/s; the kernel is first held to its plain version on the timed
   inputs, and that error is the entry's ``max_abs_err``;
7. the model path at full width: qwen2-0.5b as published (24 layers,
   d_model 896, 14/2 heads, vocab 151,936, bf16), weights from
   ``torch.Generator`` seed 0 on the card; prefill 8 prompts of 512
   tokens, 32 ``decode_step``s, then the same 32 tokens through
   ``decode_multi`` from the same cache: the streams must be equal, the
   logits finite, and the flash (B3) and decode (B2) attention kernels
   launched at least 24 and 24 x 32 times; prefill and per-token decode
   times with CUDA events, then the device's busy share of a prefill and
   of four decode steps from ``torch.profiler`` (kernel time over wall
   time, the profiler on);
8. token identity of the model path: qwen2-0.5b at full width in float32,
   the same weights on the card and on the CPU (plain versions there),
   one 64-token prompt and 16 greedy tokens must agree;
9. B2 and B3 against their plain versions on the card, float32 and
   bfloat16 (atol = rtol = 2e-5 and 2e-2), on the cases of
   tests/test_torch_attention_cuda.py: tests/test_kernels.py's edge cases,
   head dims 16/32/256, a GQA group of 48, the model's layouts at
   qwen2-0.5b's heads, and B2 at phase 7's decode shape (8 rows over 544
   slots, one shared length: 513 and 544);
10. B2 and B3 times at qwen2-0.5b's heads in bf16 with CUDA events (B3 at
   8 x 512 tokens, phase 7's prefill shape, and 1 x 4096, causal; B2 at 64
   rows over 4096 slots), each first held to its plain version on the
   timed inputs (atol = rtol = 2e-2; that error is the entry's
   ``max_abs_err``), then timed beside its plain version,
   ``scaled_dot_product_attention`` with
   ``enable_gqa`` as a yardstick the port never calls (first checked to
   compute the same function) and its bound: the larger of its bytes over
   3.35 TB/s and its operations over 989 TFLOP/s (bf16).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
TOL = dict(atol=1e-5, rtol=1e-5)
SERVE_TIMEOUT_S = 420


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# -- phase 3: the serving path, in subprocesses ------------------------------

def serve(*extra: str) -> dict:
    """Run the port's serve CLI at qwen2-0.5b widths; returns completion
    and the workers' summed kernel launches."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--backend", "torch", "--arch", "qwen2-0.5b", "--tp", "2",
           "--cores", "6", "--requests", "8", "--rps", "16",
           "--words", "400", "--max-new", "16", *extra]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=SERVE_TIMEOUT_S)
    finally:
        if proc.poll() is None:           # stop the whole process group
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"  {line}")
    if proc.returncode != 0:
        fail(f"serve {' '.join(extra)} exited {proc.returncode}")
    done = re.search(r"\[serve\] completed (\d+)/(\d+)", out)
    launches = re.search(r"kernel_launches=(\d+)", out)
    if not done or not launches:
        fail("serve printed no completion or launch count")
    n_done, n_req = int(done.group(1)), int(done.group(2))
    if n_done != n_req:
        fail(f"serve {' '.join(extra)} completed {n_done}/{n_req}")
    n_launch = int(launches.group(1))
    if n_launch <= 0:
        fail(f"serve {' '.join(extra)}: the kernel was never launched")
    log(f"serve {' '.join(extra)}: {n_done}/{n_req} requests, "
        f"{n_launch} kernel launches, {wall:.1f} s wall")
    return {"completed": n_done, "launches": n_launch, "wall_s": wall}


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "card")

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build (nvcc only; the serve subprocesses reuse the library)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build_library()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Function properties" \
                in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")

    # 3. serving, before this process touches the card's memory
    fp32_run = serve("--multi-step", "4")
    int8_run = serve("--kv-dtype", "int8")

    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention as kernel,
        paged_decode_attention_reference as plain,
    )
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 4. kernel vs plain version
    worst = {"float32": 0.0, "int8": 0.0}
    for quantized in (False, True):
        for case in edge_cases(quantized) + [serving_case(quantized, dev,
                                                          ragged=True)]:
            args, kw = to_device(case, dev)
            got = kernel(*args, **kw)
            torch.cuda.synchronize()
            want = plain(*args, **kw)
            err = (got - want).abs().max().item()
            key = "int8" if quantized else "float32"
            worst[key] = max(worst[key], err)
            if not torch.allclose(got, want, **TOL):
                fail(f"kernel disagrees with its plain version "
                     f"({key}, q {tuple(args[0].shape)}, pages "
                     f"{tuple(args[1].shape)}): max abs err {err:.3g}")
    log(f"kernel vs plain version: max abs err fp32 {worst['float32']:.3g}, "
        f"int8 {worst['int8']:.3g} (atol = rtol = 1e-5)")

    # 5. token identity on the card and on the CPU, at small width
    token_identity()

    # 6. times at the serving shapes
    entries = []
    for quantized, run in ((False, fp32_run), (True, int8_run)):
        entries.append(time_kernel(quantized, dev, run["launches"], worst))

    # 7.-10. the model path, its kernels B2 and B3
    launches = model_path(dev)
    model_token_identity(dev)
    attention_vs_plain(dev)
    entries += time_attention(dev, launches)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# -- phase 4: inputs --------------------------------------------------------

def edge_cases(quantized: bool) -> list:
    """The CPU tests' edge cases (tests/test_torch_paged_attention.py):
    ragged lengths, a -1 page inside a valid range, seq_len-0 rows on real
    and on -1 pages, a row of only -1 pages; r in {1, 2, 7, 16}, D in
    {16, 32, 64, 128}, block 8 and 16."""
    import numpy as np
    out = []
    for r in (1, 2, 7, 16):
        for D in (16, 32, 64, 128):
            for block in (8, 16):
                rng = np.random.default_rng(1000 * r + 10 * D + block)
                KV, N, nb = 2, 24, 5
                lens = [3 * block + 5, block, 0, 2 * block + 1, 0,
                        block + 3, 4]
                perm = rng.permutation(N)
                bt = np.full((len(lens), nb), -1, np.int32)
                used = 0
                for b, n_tok in enumerate(lens):
                    n_pages = -(-n_tok // block)
                    bt[b, :n_pages] = perm[used:used + n_pages]
                    used += n_pages
                bt[0, 1] = -1
                bt[2, :2] = perm[used:used + 2]
                bt[6, :] = -1
                case = dict(
                    q=rng.standard_normal((len(lens), r * KV, D)),
                    block_tables=bt, seq_lens=np.asarray(lens, np.int32))
                add_pages(case, rng, (KV, N, block, D), quantized)
                out.append(case)
    return out


def add_pages(case: dict, rng, shape, quantized: bool) -> None:
    import numpy as np
    if quantized:
        case["k_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["v_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["k_scales"] = rng.uniform(0.1, 3.0, shape[:2])
        case["v_scales"] = rng.uniform(0.1, 3.0, shape[:2])
    else:
        case["k_pages"] = rng.standard_normal(shape)
        case["v_pages"] = rng.standard_normal(shape)


def serving_case(quantized: bool, dev, *, ragged: bool,
                 rows: int = 64) -> dict:
    """qwen2-0.5b widths (H 14, KV 2, D 64), block 64, ``rows`` rows of up
    to 32 pages each over a pool of rows * 32 pages.  ``ragged``: random
    lengths, a seq_len-0 row and -1 entries; else every row at its full
    2048 slots."""
    import numpy as np
    rng = np.random.default_rng(7 + quantized)
    B, H, KV, D, block, nb = rows, 14, 2, 64, 64, 32
    N = B * nb
    bt = rng.permutation(N).astype(np.int32).reshape(B, nb)
    if ragged:
        lens = rng.integers(1, nb * block + 1, B).astype(np.int32)
        lens[3] = 0
        for b in range(B):
            bt[b, -(-int(lens[b]) // block):] = -1     # past the length
        bt[5, 2] = -1                                   # inside it
    else:
        lens = np.full(B, nb * block, np.int32)
    case = dict(q=rng.standard_normal((B, H, D)), block_tables=bt,
                seq_lens=lens)
    add_pages(case, rng, (KV, N, block, D), quantized)
    return case


def to_device(case: dict, dev):
    import torch
    conv = {}
    for k, v in case.items():
        t = torch.from_numpy(v)
        if t.dtype == torch.float64:
            t = t.float()
        conv[k] = t.to(dev).contiguous()
    args = [conv[k] for k in ("q", "k_pages", "v_pages", "block_tables",
                              "seq_lens")]
    kw = {k: conv[k] for k in ("k_scales", "v_scales") if k in conv}
    return args, kw


# -- phase 5 ---------------------------------------------------------------

def token_identity() -> None:
    import torch

    from repro_torch.backend.torch_backend import TorchBackend
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    base = dict(max_num_seqs=8, max_tokens_per_step=64, prefill_chunk=16,
                block_size=8)
    runs = {
        "k1": (dict(base, enable_prefix_cache=True, kv_capacity_tokens=512),
               [(21, 3, 1), (40, 5, 2), (21, 2, 1), (9, 4, 3)]),
        "k4_swap": (dict(base, enable_prefix_cache=False,
                         kv_capacity_tokens=96, preemption_policy="swap",
                         swap_capacity_tokens=256,
                         max_steps_per_dispatch=4),
                    [(40, 24, 1), (37, 24, 2)]),
    }
    for name, (cfg_kw, specs) in runs.items():
        streams = {}
        for device in ("cuda", "cpu"):
            cfg = SchedulerConfig(**cfg_kw)
            sched = Scheduler(cfg)
            be = TorchBackend(block_size=cfg.block_size,
                              num_blocks=cfg.num_kv_blocks,
                              num_swap_blocks=cfg.num_swap_blocks,
                              vocab=128, device=device)
            reqs = []
            for i, (n, max_new, stream) in enumerate(specs):
                r = Request(text="", max_new_tokens=max_new, req_id=i)
                r.prompt_tokens = [3 + (((stream << 10) + j) % 100)
                                   for j in range(n)]
                sched.add_request(r)
                reqs.append(r)
            step = 0
            while sched.has_work and step < 500:
                plan = sched.schedule()
                if plan is None:
                    break
                step += 1
                for req in sched.complete_step(plan, float(step),
                                               be.execute(plan)):
                    be.release(req.req_id)
            streams[device] = [list(r.generated) for r in reqs]
        torch.cuda.synchronize()
        if streams["cuda"] != streams["cpu"]:
            fail(f"token streams differ between cuda and cpu ({name}): "
                 f"{streams['cuda']} vs {streams['cpu']}")
        log(f"token identity {name}: cuda == cpu over "
            f"{sum(map(len, streams['cuda']))} tokens")


# -- phase 6 ---------------------------------------------------------------

def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(args, kw) -> tuple:
    """Least time for this call on the card: each input byte the rows
    need read once (the K/V pages up to each row's length, all pages for
    a row with no valid slot, their scales, q, tables, lengths) and the
    output written once, over 3.35 TB/s; against 4*D float32 operations
    per (query head, slot) for QK^T and PV, over 67 TFLOP/s."""
    q, k_pages, _, bt, sl = args
    B, H, D = q.shape
    KV, N, block, _ = k_pages.shape
    pages = 0
    for n_tok in sl.tolist():
        need = min(math.ceil(n_tok / block), bt.shape[1])
        pages += need if n_tok > 0 else bt.shape[1]
    elt = k_pages.element_size()
    nbytes = (2 * KV * pages * block * D * elt          # K and V pages
              + (2 * KV * pages * 4 if kw else 0)       # their scales
              + 2 * q.numel() * 4                       # q in, out
              + bt.numel() * 4 + sl.numel() * 4)
    flops = 4 * (H // KV) * KV * pages * block * D      # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def time_kernel(quantized: bool, dev, launches: int, worst: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention as kernel,
        paged_decode_attention_reference as plain,
    )
    args, kw = to_device(serving_case(quantized, dev, ragged=False), dev)
    q, k_pages, v_pages, bt, sl = args
    B, H, D = q.shape
    KV, _, block, _ = k_pages.shape
    key = "int8" if quantized else "float32"
    got, want = kernel(*args, **kw), plain(*args, **kw)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, **TOL):
        fail(f"kernel disagrees with its plain version at the timed shape "
             f"({key}): max abs err {err:.3g}")
    # kernel, plain, plain, kernel: the order guards against drift
    ms = cuda_ms(lambda: kernel(*args, **kw))
    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=5)
    plain_ms = min(plain_ms, cuda_ms(lambda: plain(*args, **kw), iters=5))
    ms = min(ms, cuda_ms(lambda: kernel(*args, **kw)))
    bound_ms, bound_by, nbytes = bound(args, kw)
    library_ms = None
    if not quantized:
        # yardstick only: SDPA over the gathered contiguous K/V (the same
        # function when every row is at full length); never called by
        # the port
        idx = bt.long()
        kc = k_pages[:, idx].reshape(KV, B, -1, D).permute(1, 0, 2, 3)
        vc = v_pages[:, idx].reshape(KV, B, -1, D).permute(1, 0, 2, 3)
        kc = kc.repeat_interleave(H // KV, dim=1).contiguous()
        vc = vc.repeat_interleave(H // KV, dim=1).contiguous()
        q4 = q[:, :, None, :]
        got = F.scaled_dot_product_attention(q4, kc, vc)[:, :, 0]
        if not torch.allclose(got, kernel(*args, **kw), atol=1e-3,
                              rtol=1e-3):
            fail("SDPA yardstick does not compute the kernel's function")
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q4, kc, vc))
    name = "paged_decode_attention_" + ("i8" if quantized else "f32")
    log(f"{name}: B={B} H={H} KV={KV} D={D} block={block} "
        f"pages/row={bt.shape[1]}: max abs err {err:.3g} (all cases "
        f"{worst[key]:.3g}), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {library_ms} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}, {nbytes} B), achieved "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
    # the smoke serving runs' batch: one block per (row, kv head) fills
    # 16 of the 132 SMs
    args8, kw8 = to_device(serving_case(quantized, dev, ragged=False,
                                        rows=8), dev)
    log(f"{name} at 8 rows: kernel "
        f"{cuda_ms(lambda: kernel(*args8, **kw8)):.4f} ms, bound "
        f"{bound(args8, kw8)[0]:.4f} ms")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:164",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# -- phase 7: the model path at full width -----------------------------------

def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def model_path(dev) -> dict:
    """qwen2-0.5b bf16 at full width: prefill 8 x 512, 32 decode_steps,
    the same 32 tokens through decode_multi.  Returns the B3 and B2 launch
    counts of this run (set to 0 just before it, read just after)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_bhd
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.models import model as M

    cfg = get_config("qwen2-0.5b")
    B, S, N = 8, 512, 32
    t0 = time.perf_counter()
    model = M.Model(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    # warm-up at the timed shapes (cuBLAS, the kernel library, the caching
    # allocator), not counted
    _, c = model.prefill(toks)
    c = M.grow_cache(c, cfg, B, S + N)
    for i in range(4):
        model.decode_step(toks[:, :1], c, S + i)
    del c
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {n_params} parameters ({cfg.dtype}), built and "
        f"warmed in {time.perf_counter() - t0:.1f} s")

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    flash_attention_bhsd.launches = 0
    decode_attention_bhd.launches = 0
    start.record()
    logits, cache = model.prefill(toks)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    n_flash = flash_attention_bhsd.launches
    if not torch.isfinite(logits).all():
        fail("prefill logits are not finite")
    cache = M.grow_cache(cache, cfg, B, S + N)
    saved = _clone(cache)
    first = logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    tok, steps = first, []
    start.record()
    for i in range(N):
        logits, cache = model.decode_step(tok, cache, S + i)
        tok = logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        steps.append(tok[:, 0])
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / N
    if not torch.isfinite(logits).all():
        fail("decode logits are not finite")
    start.record()
    fused, _, clen = model.decode_multi(first, saved, S, N)
    end.record()
    torch.cuda.synchronize()
    multi_ms = start.elapsed_time(end) / N
    counts = {"flash": flash_attention_bhsd.launches,
              "decode": decode_attention_bhd.launches}
    busy = {
        "prefill": device_share(lambda: model.prefill(toks)),
        "decode_step x4": device_share(lambda: [
            model.decode_step(first, saved, S + i) for i in range(4)]),
    }
    stepwise = torch.stack(steps, 1)
    if not torch.equal(fused, stepwise) or int(clen) != S + N:
        fail(f"decode_multi differs from stepwise decoding: "
             f"{fused.tolist()} vs {stepwise.tolist()}")
    n_layers = cfg.n_layers
    if n_flash < n_layers or counts["flash"] < n_layers:
        fail(f"flash attention kernel launched {n_flash} times in prefill, "
             f"want >= {n_layers}")
    if counts["decode"] < n_layers * N:
        fail(f"decode attention kernel launched {counts['decode']} times, "
             f"want >= {n_layers * N}")
    log(f"model path: prefill {B} x {S} tokens {prefill_ms:.3f} ms; decode "
        f"{B} rows: decode_step {step_ms:.3f} ms/token, decode_multi "
        f"{multi_ms:.3f} ms/token; streams equal over {B} x {N} tokens; "
        f"launches flash {counts['flash']}, decode {counts['decode']}")
    for what, (wall_ms, dev_ms, n_kernels, top) in busy.items():
        share = f"{dev_ms / wall_ms:.3f}" if dev_ms else "not measured"
        log(f"profile {what}: wall {wall_ms:.3f} ms (profiler on), device "
            f"kernels {dev_ms:.3f} ms in {n_kernels} launches, busy share "
            f"{share}; top: {top}")
    return counts


def device_share(fn) -> tuple:
    """Wall time of ``fn`` (ending in a synchronize) and the device time of
    the kernels it ran, from ``torch.profiler``: (wall ms, device ms,
    kernel count, the four largest kernels by device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    return (wall_ms, dev_us / 1e3, sum(e.count for e in kernels),
            [(e.key[:60], round(e.self_device_time_total / 1e3, 4), e.count)
             for e in top])


# -- phase 8: token identity of the model path --------------------------------

def model_token_identity(dev) -> None:
    """qwen2-0.5b in float32 at full width, the same weights on the card
    and on the CPU: one 64-token prompt, 16 greedy tokens."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("qwen2-0.5b").scaled(dtype="float32")
    S, N = 64, 16
    t0 = time.perf_counter()
    cpu = M.Model(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (1, S)).astype(np.int32)
    streams = {}
    for name, model in (("cuda", card), ("cpu", cpu)):
        t = torch.from_numpy(toks).to(model.device)
        logits, cache = model.prefill(t)
        cache = M.grow_cache(cache, cfg, 1, S + N)
        first = logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)
        fused, _, _ = model.decode_multi(first[:, None], cache, S, N)
        streams[name] = [int(first[0])] + fused[0].tolist()
    if streams["cuda"] != streams["cpu"]:
        fail(f"model tokens differ between cuda and cpu: {streams['cuda']} "
             f"vs {streams['cpu']}")
    log(f"model token identity (float32, full width): cuda == cpu over "
        f"{len(streams['cpu'])} tokens ({time.perf_counter() - t0:.1f} s)")
    del card
    torch.cuda.empty_cache()


# -- phase 9: B2 and B3 against their plain versions ---------------------------

def _attention_cases():
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_attention_cuda as cases
    return cases


def model_path_decode(dev, dtype, valid: int) -> dict:
    """B2's inputs as phase 7's decode steps give them: 8 rows over a
    [8, 544, 2, 64] cache (512 prompt slots grown by 32), one ``valid``
    length shared by every row (a broadcast [B] tensor, stride 0) and
    linear slot positions."""
    import torch
    c = _attention_cases().model_decode(dev, dtype, B=8, Sc=544)
    c["cache_len"] = torch.tensor([valid], dtype=torch.int32,
                                  device=dev).expand(8)
    return c


def attention_vs_plain(dev) -> dict:
    """Worst abs error per (kernel, dtype) over the cases; fails outside
    atol = rtol = 2e-5 (float32) / 2e-2 (bfloat16)."""
    import torch

    from repro_torch.kernels.decode_attention import (
        decode_attention_bhd, decode_attention_reference)
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd, flash_attention_reference)
    cases = _attention_cases()
    worst = {}
    n = 0
    for dname, dtype in cases.DTYPES.items():
        tol = cases.TOLS[dname]
        todo = ([("flash", cases.to_torch(c, dev, dtype))
                 for _, c in cases.flash_cases()]
                + [("decode", cases.to_torch(c, dev, dtype))
                   for _, c in cases.decode_cases()]
                + [("flash", cases.model_flash(dev, dtype, window=w))
                   for w in (None, 16)]
                + [("decode", cases.model_decode(dev, dtype, window=w))
                   for w in (None, 16)]
                + [("decode", model_path_decode(dev, dtype, n))
                   for n in (513, 544)])
        for kind, c in todo:
            if kind == "flash":
                got = cases.run_flash(flash_attention_bhsd, c)
                torch.cuda.synchronize()
                want = cases.run_flash(flash_attention_reference, c)
            else:
                got = cases.run_decode(decode_attention_bhd, c)
                torch.cuda.synchronize()
                want = cases.run_decode(decode_attention_reference, c)
            err = (got.float() - want.float()).abs().max().item()
            worst[(kind, dname)] = max(worst.get((kind, dname), 0.0), err)
            n += 1
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                fail(f"{kind} attention kernel disagrees with its plain "
                     f"version ({dname}, q {tuple(c['q'].shape)}, k "
                     f"{tuple(c['k'].shape)}, window {c['window']}): max "
                     f"abs err {err:.3g}")
    log(f"B2/B3 kernel vs plain version over {n} calls: max abs err "
        + ", ".join(f"{k} {d} {e:.3g}" for (k, d), e in sorted(worst.items()))
        + " (atol = rtol = 2e-5 fp32, 2e-2 bf16)")
    return worst


# -- phase 10: B2 and B3 times --------------------------------------------------

def _bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _time_pair(kernel, plain) -> tuple:
    """Best of two rounds, in the order kernel, plain, plain, kernel."""
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, iters=5)
    plain_ms = min(plain_ms, cuda_ms(plain, iters=5))
    return min(ms, cuda_ms(kernel)), plain_ms


def _held_to_plain(got, want, what: str) -> float:
    """Max abs error of a kernel's output against its plain version on
    the same inputs; fails outside atol = rtol = 2e-2 (bfloat16)."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2):
        fail(f"{what}: kernel disagrees with its plain version at the timed "
             f"shape: max abs err {err:.3g}")
    return err


def time_attention(dev, launches: dict) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention_bhd, decode_attention_reference)
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd, flash_attention_reference)
    cases = _attention_cases()
    bf16 = torch.bfloat16
    H, KV, D = 14, 2, 64
    out = []
    for B, S in ((8, 512), (1, 4096)):
        c = cases.model_flash(dev, bf16, B=B, S=S, H=H, KV=KV, D=D)
        q, k, v = c["q"], c["k"], c["v"]
        got = cases.run_flash(flash_attention_bhsd, c)
        name = f"flash_attention_bf16_b{B}_s{S}"
        err = _held_to_plain(got, cases.run_flash(flash_attention_reference,
                                                  c), name)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        if not torch.allclose(sdpa().float(), got.float(), atol=2e-2,
                              rtol=2e-2):
            fail("SDPA yardstick does not compute flash attention's function")
        ms, plain_ms = _time_pair(
            lambda: cases.run_flash(flash_attention_bhsd, c),
            lambda: cases.run_flash(flash_attention_reference, c))
        library_ms = cuda_ms(sdpa)
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KV * D)  # q, o, k, v
        flops = 4 * D * H * B * S * (S + 1) // 2                # kept pairs
        bound_ms, bound_by = _bound(nbytes, flops)
        log(f"{name}: H={H} KV={KV} D={D} causal: max abs err {err:.3g}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {nbytes} B, {flops} flop), "
            f"achieved {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:77",
                    "launches": launches["flash"],
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms})

    B, Sc = 64, 4096
    c = cases.model_decode(dev, bf16, B=B, Sc=Sc, H=H, KV=KV, D=D)
    c["cache_len"] = torch.full((B,), Sc, dtype=torch.int32, device=dev)
    got = cases.run_decode(decode_attention_bhd, c)
    name = f"decode_attention_bf16_b{B}_s{Sc}"
    err = _held_to_plain(got, cases.run_decode(decode_attention_reference, c),
                         name)
    q4 = c["q"][:, :, None]                                 # [B, H, 1, D]
    mask = ((c["positions"] >= 0) & (c["positions"] < c["cache_len"][:, None])
            )[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, c["k"], c["v"],
                                              attn_mask=mask, enable_gqa=True)
    if not torch.allclose(sdpa()[:, :, 0].float(), got.float(), atol=2e-2,
                          rtol=2e-2):
        fail("SDPA yardstick does not compute decode attention's function")
    ms, plain_ms = _time_pair(
        lambda: cases.run_decode(decode_attention_bhd, c),
        lambda: cases.run_decode(decode_attention_reference, c))
    library_ms = cuda_ms(sdpa)
    nbytes = (2 * 2 * B * H * D + 2 * 2 * B * Sc * KV * D   # q, o, k, v
              + 4 * B + 4 * Sc)                             # lengths, positions
    flops = 4 * D * H * B * Sc                              # every slot kept
    bound_ms, bound_by = _bound(nbytes, flops)
    log(f"{name}: H={H} KV={KV} D={D}: max abs err {err:.3g}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}; {nbytes} B), achieved "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
    out.append({"name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:72",
                "launches": launches["decode"],
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms})
    return out


if __name__ == "__main__":
    main()
