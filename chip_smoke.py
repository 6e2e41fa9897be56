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
   3.35 TB/s.

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
    key = "int8" if quantized else "float32"
    log(f"{name}: B={B} H={H} KV={KV} D={D} block={block} "
        f"pages/row={bt.shape[1]}: kernel {ms:.4f} ms, plain "
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
            "launches": launches, "max_abs_err": worst[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


if __name__ == "__main__":
    main()
