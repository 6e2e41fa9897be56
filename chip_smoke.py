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
   = 1e-5; then the split over pages at forced split counts (1 to one
   page a split, through the private ``_launch``), on the edge cases and
   at 8 and 64 serving rows, seq_len-0 rows and a row whose valid pages
   lie in one split among them;
5. token identity: ``TorchBackend`` on the card and on the CPU sample the
   same tokens on the conformance workload (k=1, and k=4 under swap
   churn);
6. times at the serving shapes, 64 rows and the serve runs' 8 rows of 32
   full pages, fp32 and int8, with CUDA events: the kernel, the plain
   version, ``scaled_dot_product_attention`` over the gathered contiguous
   K/V as a yardstick (the port never calls it), and the bytes bound at
   3.35 TB/s, with the kernel's and SDPA's device time per call from
   ``torch.profiler`` (phase 10's helper); the kernel is first held to its
   plain version on the timed inputs, and that error is the entry's
   ``max_abs_err``;
7. the model path at full width: qwen2-0.5b as published (24 layers,
   d_model 896, 14/2 heads, vocab 151,936, bf16), weights from
   ``torch.Generator`` seed 0 on the card; prefill 8 prompts of 512
   tokens, 32 ``decode_step``s, then the same 32 tokens through
   ``decode_multi`` from the same cache: the streams must be equal, the
   logits finite, and the flash (B3) and decode (B2) attention kernels
   launched at least 24 and 24 x 32 times, B3's 24 prefill launches on
   its tensor-core (``wgmma``) route; prefill and per-token decode
   times with CUDA events, then the device's busy share of a prefill and
   of four decode steps from ``torch.profiler`` (kernel time over wall
   time, the profiler on);
8. token identity of the model path: qwen2-0.5b at full width in float32,
   the same weights on the card and on the CPU (plain versions there),
   one 64-token prompt and 16 greedy tokens must agree (TF32 off);
9. B2 and B3 against their plain versions on the card, float32 and
   bfloat16 (tests/test_torch_attention_cuda.py's ``KERNEL_TOLS``: atol
   = rtol = 2e-5; rtol = 2e-2 with atol = 8e-3 for B3 and 2e-3 for B2), on
   the cases of
   tests/test_torch_attention_cuda.py: tests/test_kernels.py's edge cases,
   head dims 16/32/256, a GQA group of 48, the model's layouts at
   qwen2-0.5b's heads, and the model paths' own shapes at the heads of
   qwen2-0.5b (H 14, KV 2) and of zamba2-1.2b's shared block (H 32, KV
   32): B3 at the 8 x 512 prefill and B2 at the decode steps over its
   cache (8 rows over 544 slots, one shared length: 513 and 544); then
   the card-only cases of the new designs: B3's tensor-core route (bf16,
   D 64/128/256, S 1 to 512, causal, bidirectional and window 16, GQA
   groups of 1, 7 and 48) and B2's split over the cache (split counts from
   1 to one per tile, a row with no kept slot, a window and a ring whose
   kept slots lie in one split), float32 and bfloat16; the log gives
   the worst error and the worst excess of an error over rtol times the
   plain value (the atol that case needed);
10. B2 and B3 times in bf16 with CUDA events: B3 at qwen2-0.5b's heads at
   8 x 512 tokens (phase 7's prefill shape) and 1 x 4096, causal, and at
   8 x 512 with zamba2-1.2b's shared-block heads (32/32, D 64) and with
   olmo-1b's (16/16, D 128); B2 at qwen2-0.5b's heads at 64 rows over 4096
   slots and at phase 7's decode shape, 8 rows over 544 slots; each first
   held to its plain version on the timed inputs (bf16 ``KERNEL_TOLS``;
   that error is the entry's ``max_abs_err``), then timed beside its plain
   version, ``scaled_dot_product_attention`` with ``enable_gqa`` as a
   yardstick the port never calls (first checked to compute the same
   function) and its bound: the larger of its bytes over 3.35 TB/s and
   its operations over 989 TFLOP/s (bf16); the log adds the kernel's and
   SDPA's device time per call from ``torch.profiler``, which leaves out
   the host's work between back-to-back launches;
11. B4 (the Mamba-1 selective scan) against its plain version on the
   card, float32, atol = rtol = 1e-4 on both y and h_last, on the cases of
   tests/test_torch_mamba_scan_cuda.py: tests/test_kernels.py's three
   shapes, a ragged Di, nonzero initial states, d_state 32 and 64, and
   falcon-mamba-7b's width (8 x 8192 channels, d_state 16) at T = 1 from a
   state, at T = 1 writing h_last over h0 (as a decode step writes its
   cache entry) and at T = 512; then every d_state with its lanes per
   channel at T = 1, 15, 17 and 40 (tiles of 16 steps), and h_last over h0
   at every d_state with 16-byte and 4-byte copies;
12. the state-space path at full width: falcon-mamba-7b as published (64
   Mamba-1 layers, d_model 4096, d_inner 8192, d_state 16, dt_rank 256,
   vocab 65,024, untied, bf16; 7,272,665,088 parameters), run as phase 7
   runs qwen2-0.5b; B4 launched at least 64 times in the prefill and
   64 x 32 times in the 32 decode steps; the model is freed afterwards;
13. zamba2-1.2b as published (38 Mamba-2 layers as 6 periods of
   [shared attention, ssm x6] and a tail [shared attention, ssm x2],
   d_model 2048, 32/32 heads, d_ff 8192, vocab 32,000, bf16), the same run;
   B3 launched at least 7 times per prefill, all on its ``wgmma`` route,
   and B2 at least 7 times per decode step (the shared block's 7 calls);
14. token identity of the state-space path, float32, TF32 off, as phase 8:
   falcon-mamba-7b at full width cut to 4 of its 64 layers (the full
   depth in float32 is about 29 GB and too slow on the CPU), and
   zamba2-1.2b at full width cut to 8 of its 38 layers (one period of
   [shared attention, ssm x6] and the tail [shared attention, ssm x2], so
   both stages, B3 and B2 run; the cut keeps the CPU's share short);
15. B4 times at phase 12's shapes, the prefill (8 x 512 from zero) and
   one decode step (8 x 1 from a state): each first held to its plain
   version on the timed inputs (1e-4; that error is the entry's
   ``max_abs_err``), then timed beside its plain version, with its bound
   (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s) and its
   device time per call (phase 10's helper); no one PyTorch call computes
   the scan, so its ``library_ms`` is null;
16. hybrid serve: ``serve --backend hybrid --prefill-backend torch
   --decode-backend cpu`` (prefill on the card, decode on the CPU, pages
   handed across), in fp32 and with ``--kv-dtype int8`` (the decode tier
   int8); every request completes, B1 is launched (by the prefill tier),
   and the handoff counters are printed;
17. speculative serve: ``serve --backend torch --speculative-k 4
   --draft-backend cpu`` (target on the card, draft on the CPU), in fp32
   and with ``--kv-dtype int8``; every request completes, B1 is launched
   (by the batched verify), and the drafted and accepted counts are
   printed;
18. fleet serve: ``serve --backend torch --replicas 2 --tp 1 --routing
   affinity``; every request completes, both replicas launch B1, and the
   per-replica request counts are printed;
19. token identity of the compositions at phase 5's small width: phase
   5's plans through ``TorchBackend`` on the card and on the CPU, the
   hybrid (torch on the card -> cpu), speculative decode with the target
   on the card and a cpu draft (k 3; and a draft drawn from another seed,
   so that verify rejects) and speculative decode on the CPU: the streams
   must all be equal, and in int8 the hybrid with the card's prefill tier
   must equal the all-CPU hybrid; then at the serve runs' widths
   (qwen2-0.5b's heads and vocab, block 64, 8 requests of 512 prompt
   tokens), speculative decode (k 4, draft and target on the card) must
   equal stepwise decode on the card, though B1 splits a verify call and
   a decode step differently;
20. B1 at speculative verify's call shape: 8 requests x 5 rows (k 4)
   sharing their tables of 32 pages, seq_lens start+1 .. start+5, at
   qwen2-0.5b's heads (block 64, the 256-page pool of phase 6's 8 rows),
   fp32 and int8: held to the plain version and to the split rule
   (1e-5), then timed as phase 6 times B1, with SDPA over the gathered
   K/V under a length mask for fp32; the log also gives the largest
   difference between the rule's split count at 40 rows and the count a
   decode step of the same 8 requests takes;
21. the moe path at full width: granite-moe-3b-a800m as published (32
   layers, d_model 1536, 24/8 heads at D 64, 40 experts top-8 with d_ff
   512, vocab 49,155, tied, bf16), run as phase 7 runs qwen2-0.5b; B3
   launched at least 32 times per prefill, all on its ``wgmma`` route,
   and B2 at least 32 times per decode step;
22. qwen2-moe-a2.7b as published (24 layers, d_model 2048, 16/16 heads at
   D 128, 60 experts top-4 with d_ff 1408 and 4 shared experts, vocab
   151,936, untied, bf16; about 28.6 GB of weights, freed afterwards), the
   same run with 24 launches per prefill and per step;
23. the encoder-decoder path: whisper-small as published (12 encoder and
   12 decoder layers, d_model 768, 12/12 heads at D 64, vocab 51,865,
   bf16), 8 x 1,500 random frames for its encoder, a decoder prompt of
   8 x 64 tokens and 32 steps (96 positions, within its 448); B3 launched
   at least 24 times per prefill (12 bidirectional over the frames, 12
   causal), all on ``wgmma``, and B2 at least 24 times per step (12
   self-attention, 12 cross over the 1,500 slots);
24. token identity of those paths, float32, TF32 off, as phase 8, at full
   width cut in depth: granite-moe to 4 of 32 layers, qwen2-moe to 2 of
   24, whisper to 2 encoder and 2 decoder layers with 1,500 frames; the
   moe archs under the near-tie rule (``model_token_identity``: expert
   sets compared call by call, a difference must be a near-tie of the
   CPU's probabilities within 1e-5, and a run with one is logged and
   retried with the next prompt seed, at most three); then B3 at
   whisper's encoder shape (8 x 1,500, bidirectional) and B2 at its
   cross-attention decode (8 rows x 1,500 slots) held to their plain
   versions and timed as phase 10 times B3 and B2;
25. the calibration on the card: ``repro_torch.launch.dryrun.
   emit_devmodel("qwen2-0.5b")`` at full width in bf16 (weights and data
   from seeded generators) times ``Model.prefill`` over prefill_32k's
   32 x 32,768 tokens and one ``decode_step`` of decode_32k's 128 rows
   over a cache of 32,768 slots filled from the generator (a batch is
   halved only where the card's memory does not hold it, and the record
   lists each cut), CUDA events, the median of three calls after a
   warm-up; every coefficient must be finite and positive, ``measured_on``
   must name this card and its power limit in W, B3 (all on ``wgmma``)
   and B2 must have launched 24 times in each of the four calls; the
   record is logged as JSON; then ``serve --backend emulated --devmodel
   <that file>`` as a subprocess, and every request must complete; then
   B3 at 1 x 32,768 (qwen2-0.5b's heads, causal) and B2 at the decode
   step's 128 rows x 32,768 slots, shapes no earlier phase runs, held to
   their plain versions on the same inputs (B3's computed in query chunks,
   itself first held to the plain version at a small shape) at phase
   9's bf16 tolerances and timed as phase 10 times them;
26. the DES on the card's coefficients: ``repro_torch.sim``'s
   attacker/victim workload (core_sweep_sim's defaults) at tp 1 over tp+1
   .. 16 tp cores on ``llama8b_tp4_params`` with its device and the
   scheduler's preemption calibration replaced by phase 25's
   ``DeviceModel``; victim TTFT and CPU saturation per core count, and
   fewer cores may never give a lower TTFT (the reference's
   ``test_fewer_cores_is_never_faster``, 0.1%);
27. the attacker/victim example on the card: ``python -m
   repro_torch.launch.serve_contention --backend torch --arch
   qwen2-0.5b`` as a subprocess (run with phases 16-18, before this
   process touches the card); both runs (idle, then 12 attackers)
   complete without a victim timeout and launch B1; the victim's TTFT,
   tokenize and dequeue p95, each worker's start-up and the start-up's
   share of the TTFT are logged.

The line before the last is the ``kernels`` JSON (B1-B4, as timed in the
phases above); the last line is ``{"ok": true, "device": {...}}``.
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


# -- phases 3 and 16-18: the serving path, in subprocesses --------------------

COMPOSITE = ("handoffs", "handoff_blocks", "spec_steps", "drafted",
             "accepted")


def run_module(module: str, *args: str) -> tuple:
    """Run ``python -m module args`` from the checkout in a session of its
    own, log its output and fail the run on a non-zero exit; returns (the
    output, wall seconds).  At the time limit the whole process group is
    killed."""
    cmd = [sys.executable, "-m", module, *args]
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
        fail(f"{module} {' '.join(args)} exited {proc.returncode}")
    return out, wall


def serve(*extra: str, tp: int = 2, launched: bool = True) -> dict:
    """Run the port's serve CLI at qwen2-0.5b widths, ``extra`` naming the
    backend and its options; returns completion, the workers' summed
    kernel launches (each replica's too in fleet mode, and each must be
    above 0 unless ``launched`` is False, for the emulated backend), TTFT
    p50, wall time, the composite backends' counters summed over the
    workers and the fleet's per-replica request counts."""
    out, wall = run_module(
        "repro_torch.launch.serve", "--arch", "qwen2-0.5b", "--tp", str(tp),
        "--cores", "6", "--requests", "8", "--rps", "16", "--words", "400",
        "--max-new", "16", *extra)
    what = " ".join(extra)
    done = re.search(r"\[(?:serve|fleet)\] completed (\d+)/(\d+)", out)
    launches = [int(n) for n in re.findall(r"kernel_launches=(\d+)", out)]
    if not done or not launches:
        fail("serve printed no completion or launch count")
    n_done, n_req = int(done.group(1)), int(done.group(2))
    if n_done != n_req:
        fail(f"serve {what} completed {n_done}/{n_req}")
    if launched and min(launches) <= 0:
        fail(f"serve {what}: the kernel was never launched "
             f"(per replica: {launches})")
    ttft = re.search(r"TTFT p50=([\d.]+)ms", out)
    counters = {}
    for key, n in re.findall(rf"\b({'|'.join(COMPOSITE)})=(\d+)", out):
        counters[key] = counters.get(key, 0) + int(n)
    per_replica = re.search(r"per-replica requests=\[([\d, ]+)\]", out)
    run = {"completed": n_done, "launches": sum(launches),
           "replica_launches": launches, "wall_s": wall,
           "ttft_p50_ms": float(ttft.group(1)) if ttft else None,
           "counters": counters,
           "per_replica": ([int(n) for n in per_replica.group(1).split(",")]
                           if per_replica else None)}
    log(f"serve {what}: {n_done}/{n_req} requests, {sum(launches)} kernel "
        f"launches {launches}, TTFT p50 {run['ttft_p50_ms']} ms, "
        f"{wall:.1f} s wall, counters {counters}"
        + (f", per-replica requests {run['per_replica']}"
           if per_replica else ""))
    return run


def main() -> None:
    t_start = time.perf_counter()
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
    fp32_run = serve("--backend", "torch", "--multi-step", "4")
    int8_run = serve("--backend", "torch", "--kv-dtype", "int8")
    # 16.-18. the serving compositions, also before this process touches
    # the card's memory
    t_comp = time.perf_counter()
    hybrid = ("--backend", "hybrid", "--prefill-backend", "torch",
              "--decode-backend", "cpu")
    for run in (serve(*hybrid), serve(*hybrid, "--kv-dtype", "int8")):
        if run["counters"].get("handoffs", 0) < 2 * 8:
            fail(f"hybrid serve handed off {run['counters']}, want each "
                 f"of 8 requests on each of 2 workers")
    speculative = ("--backend", "torch", "--speculative-k", "4",
                   "--draft-backend", "cpu")
    spec_runs = {"float32": serve(*speculative),
                 "int8": serve(*speculative, "--kv-dtype", "int8")}
    for run in spec_runs.values():
        if run["counters"].get("spec_steps", 0) <= 0:
            fail("speculative serve ran no speculative step")
    fleet = serve("--backend", "torch", "--replicas", "2", "--routing",
                  "affinity", tp=1)
    if len(fleet["replica_launches"]) != 2:
        fail(f"fleet serve reported {fleet['replica_launches']} replicas")
    # 27. the attacker/victim example on TorchBackend, also before this
    # process touches the card's memory
    contention()
    t_comp = time.perf_counter() - t_comp

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
    paged_splits_vs_plain(dev, worst)

    # 5. token identity on the card and on the CPU, at small width
    token_identity()
    # 19. the compositions' streams at the same width
    composition_identity()

    # 6. times at the serving shapes
    entries = [time_kernel(quantized, dev, run["launches"], worst, rows)
               for rows in (64, 8)
               for quantized, run in ((False, fp32_run), (True, int8_run))]
    # 20. B1 at speculative verify's call shape
    entries += [time_verify(quantized, dev, spec_runs[key]["launches"])
                for quantized, key in ((False, "float32"), (True, "int8"))]

    # 7.-10. the model path of the attention-only archs, B3 and B2
    from repro_torch.kernels.decode_attention import decode_attention_bhd
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.mamba_scan import mamba1_scan
    n = layer_calls("qwen2-0.5b", "attn")
    launches = model_path(dev, "qwen2-0.5b", {
        "flash": (flash_attention_bhsd, n, 0),
        "decode": (decode_attention_bhd, 0, n)}, routes={"wgmma": n})
    model_token_identity(dev, "qwen2-0.5b")
    attention_vs_plain(dev)
    entries += time_attention(dev, launches)

    # 11.-15. the state-space path, B4 (and B3/B2 in zamba2's shared block)
    t_ssm = time.perf_counter()
    scan_vs_plain(dev)
    n = layer_calls("falcon-mamba-7b", "ssm")
    ssm_launches = model_path(dev, "falcon-mamba-7b",
                              {"scan": (mamba1_scan, n, n)})
    n = layer_calls("zamba2-1.2b", "shared_attn")
    model_path(dev, "zamba2-1.2b", {"flash": (flash_attention_bhsd, n, 0),
                                    "decode": (decode_attention_bhd, 0, n)},
               routes={"wgmma": n})
    # 4 of 64 layers: the full depth in float32 is about 29 GB and too slow
    # on the CPU; the widths stay as published
    model_token_identity(dev, "falcon-mamba-7b", n_layers=4)
    # 8 of 38 layers: one hybrid period and the tail, so both stages run
    model_token_identity(dev, "zamba2-1.2b", n_layers=8)
    entries += time_scan(dev, ssm_launches["scan"])

    # 21.-24. the moe and encoder-decoder paths, B3 and B2 at whisper's
    # shapes
    t_moe = time.perf_counter()
    for arch in ("granite-moe-3b-a800m", "qwen2-moe-a2.7b"):
        n = layer_calls(arch, "attn")
        model_path(dev, arch, {"flash": (flash_attention_bhsd, n, 0),
                               "decode": (decode_attention_bhd, 0, n)},
                   routes={"wgmma": n})
    enc, dec = (layer_calls("whisper-small", kind)
                for kind in ("enc_attn", "dec_attn"))
    whisper = model_path(
        dev, "whisper-small",
        {"flash": (flash_attention_bhsd, enc + dec, 0),
         "decode": (decode_attention_bhd, 0, 2 * dec)},   # self and cross
        routes={"wgmma": enc + dec}, prompt=64,
        extras=audio_frames(dev, "whisper-small", 8))
    from repro_torch.configs.base import EncDecConfig
    # depth cut so that the CPU's share stays short; widths as published
    model_token_identity(dev, "granite-moe-3b-a800m", n_layers=4)
    model_token_identity(dev, "qwen2-moe-a2.7b", n_layers=2)
    model_token_identity(dev, "whisper-small", n_layers=2,
                         encdec=EncDecConfig(n_encoder_layers=2,
                                             n_encoder_ctx=1500))
    entries += time_whisper(dev, whisper)

    # 25.-26. the calibration on the card, then the DES on its coefficients
    t_cal = time.perf_counter()
    rec, long_kernels = calibration(dev, ROOT / "build" / "devmodel")
    entries += long_kernels
    des_sweep(rec["device_model"])
    now = time.perf_counter()
    log(f"phases 1-10 and 19-20 took {t_ssm - t_start - t_comp:.1f} s, "
        f"phases 11-15 {t_moe - t_ssm:.1f} s, phases 21-24 "
        f"{t_cal - t_moe:.1f} s, phases 25-26 {now - t_cal:.1f} s, the "
        f"serve runs of phases 16-18 and 27 {t_comp:.1f} s")
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


def paged_splits_vs_plain(dev, worst: dict) -> None:
    """B1's split over pages against the plain version: the edge cases
    (nb 5, seq_len-0 rows on real and -1 pages) at 1 to 5 splits, and the
    serving shapes at 8 and 64 rows (tests/test_torch_kernels_cuda.py's
    ``serving_rows``: a seq_len-0 row, a row whose valid pages all lie in
    the first split) at the rule's count and at 1, 2, 3, 16 and 32 (one
    page a split), through the private ``_launch(n_splits=...)``."""
    import torch

    from repro_torch.kernels.paged_decode_attention import (
        _launch, paged_decode_attention_reference as plain)
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_kernels_cuda as cases
    n = 0
    for quantized in (False, True):
        key = "int8" if quantized else "float32"
        todo = [(c, s) for c in edge_cases(quantized)[::5]
                for s in (1, 2, 3, 5)]
        todo += [(cases.serving_rows(rows, quantized=quantized, seed=rows), s)
                 for rows in (8, 64) for s in (None, 1, 2, 3, 16, 32)]
        for case, n_splits in todo:
            args, kw = to_device(case, dev)
            got = _launch(*args, **kw, n_splits=n_splits)
            torch.cuda.synchronize()
            want = plain(*args, **kw)
            err = (got - want).abs().max().item()
            worst[key] = max(worst[key], err)
            n += 1
            if not torch.allclose(got, want, **TOL):
                fail(f"split kernel disagrees with its plain version ({key}, "
                     f"{n_splits} splits, q {tuple(args[0].shape)}, pages "
                     f"{tuple(args[1].shape)}): max abs err {err:.3g}")
    log(f"B1 split cases vs plain version over {n} calls: max abs err fp32 "
        f"{worst['float32']:.3g}, int8 {worst['int8']:.3g} (all phase-4 "
        f"calls; atol = rtol = 1e-5)")


# -- phases 5 and 19 -------------------------------------------------------

_BASE = dict(max_num_seqs=8, max_tokens_per_step=64, prefill_chunk=16,
             block_size=8)
TOKEN_RUNS = {
    "k1": (dict(_BASE, enable_prefix_cache=True, kv_capacity_tokens=512),
           [(21, 3, 1), (40, 5, 2), (21, 2, 1), (9, 4, 3)]),
    "k4_swap": (dict(_BASE, enable_prefix_cache=False,
                     kv_capacity_tokens=96, preemption_policy="swap",
                     swap_capacity_tokens=256, max_steps_per_dispatch=4),
                [(40, 24, 1), (37, 24, 2)]),
}


def _drive_plans(cfg_kw: dict, specs, make) -> tuple:
    """Drive ``specs`` (prompt length, max new tokens, token stream)
    through the port's scheduler and ``make(cfg)``'s backend to the end;
    returns the token streams, the backend and the speculative plans."""
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
    cfg = SchedulerConfig(**cfg_kw)
    sched = Scheduler(cfg)
    be = make(cfg)
    reqs = []
    for i, (n, max_new, stream) in enumerate(specs):
        r = Request(text="", max_new_tokens=max_new, req_id=i)
        r.prompt_tokens = [3 + (((stream << 10) + j) % 100)
                           for j in range(n)]
        sched.add_request(r)
        reqs.append(r)
    step = n_spec = 0
    while sched.has_work and step < 500:
        plan = sched.schedule()
        if plan is None:
            break
        step += 1
        n_spec += plan.speculative
        for req in sched.complete_step(plan, float(step), be.execute(plan)):
            be.release(req.req_id)
    return [list(r.generated) for r in reqs], be, n_spec


def _surrogate_kw(cfg, **extra) -> dict:
    return dict(block_size=cfg.block_size, num_blocks=cfg.num_kv_blocks,
                num_swap_blocks=cfg.num_swap_blocks,
                copy_streams=cfg.copy_streams, vocab=128, **extra)


def token_identity() -> None:
    import torch

    from repro_torch.backend.torch_backend import TorchBackend
    for name, (cfg_kw, specs) in TOKEN_RUNS.items():
        streams = {}
        for device in ("cuda", "cpu"):
            streams[device], _, _ = _drive_plans(
                cfg_kw, specs, lambda cfg: TorchBackend(
                    device=device, **_surrogate_kw(cfg)))
        torch.cuda.synchronize()
        if streams["cuda"] != streams["cpu"]:
            fail(f"token streams differ between cuda and cpu ({name}): "
                 f"{streams['cuda']} vs {streams['cpu']}")
        log(f"token identity {name}: cuda == cpu over "
            f"{sum(map(len, streams['cuda']))} tokens")


def composition_identity() -> None:
    """Phase 19: phase 5's plans through every composition; speculative
    runs take speculative_k 3 (their plans differ, their streams may
    not)."""
    from repro_torch.backend.cpu_decode import CpuDecodeBackend
    from repro_torch.backend.hybrid import HybridBackend
    from repro_torch.backend.torch_backend import TorchBackend
    from repro_torch.spec import SpeculativeBackend

    def torch_leaf(device, kv_dtype="float32"):
        return lambda cfg: TorchBackend(
            device=device, **_surrogate_kw(cfg, kv_dtype=kv_dtype))

    def hybrid(device, kv_dtype="float32"):
        return lambda cfg: HybridBackend(
            TorchBackend(device=device, **_surrogate_kw(cfg)),
            CpuDecodeBackend(**_surrogate_kw(cfg, kv_dtype=kv_dtype)),
            copy_streams=cfg.copy_streams)

    def speculative(device, draft_seed=0):
        return lambda cfg: SpeculativeBackend(
            CpuDecodeBackend(**_surrogate_kw(cfg, seed=draft_seed)),
            TorchBackend(device=device, **_surrogate_kw(cfg)))

    groups = {
        "float32": {"torch cuda": (0, torch_leaf("cuda")),
                    "torch cpu": (0, torch_leaf("cpu")),
                    "hybrid cuda->cpu": (0, hybrid("cuda")),
                    "spec k3 cuda<-cpu": (3, speculative("cuda")),
                    # a draft with other weights: verify rejects drafts
                    "spec k3 cuda<-cpu other draft": (
                        3, speculative("cuda", draft_seed=7)),
                    "spec k3 cpu<-cpu": (3, speculative("cpu"))},
        "int8": {"hybrid cuda->cpu int8": (0, hybrid("cuda", "int8")),
                 "hybrid cpu->cpu int8": (0, hybrid("cpu", "int8"))},
    }
    for run, (cfg_kw, specs) in TOKEN_RUNS.items():
        for group, builds in groups.items():
            streams, notes = {}, []
            for name, (spec_k, make) in builds.items():
                streams[name], be, n_spec = _drive_plans(
                    dict(cfg_kw, speculative_k=spec_k), specs, make)
                if spec_k:
                    if n_spec == 0:
                        fail(f"{name} ({run}): no speculative plan fired")
                    notes.append(f"{name}: {n_spec} verify plans, "
                                 f"{be.n_accepted}/{be.n_drafted} drafts "
                                 f"accepted")
                if hasattr(be, "n_handoffs"):
                    notes.append(f"{name}: {be.n_handoffs} handoffs")
            first = next(iter(streams.values()))
            for name, got in streams.items():
                if got != first:
                    fail(f"composition streams differ ({run}, {group}): "
                         f"{name} {got} vs {next(iter(streams))} {first}")
            log(f"composition identity {run} {group}: "
                + " == ".join(streams) + f" over {sum(map(len, first))} "
                f"tokens; " + "; ".join(notes))
    spec_identity_wide()


def spec_identity_wide() -> None:
    """Phase 19 at the serve runs' widths (tests/test_torch_kernels_cuda.py's
    ``serve_width_streams``): speculative decode must equal stepwise decode
    on the card where B1 splits a verify call and a decode step
    differently."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_kernels_cuda as cases
    stepwise, spec, n_spec, be = cases.serve_width_streams("cuda")
    if n_spec == 0:
        fail("no speculative plan fired at the serve runs' widths")
    if spec != stepwise:
        fail(f"speculative and stepwise streams differ at the serve runs' "
             f"widths: {spec} vs {stepwise}")
    log(f"speculative == stepwise at qwen2-0.5b widths on the card over "
        f"{sum(map(len, spec))} tokens: {n_spec} verify plans, "
        f"{be.n_accepted}/{be.n_drafted} drafts accepted")


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
    a row with no valid slot, a page that several rows share once, their
    scales, q, tables, lengths) and the output written once, over 3.35
    TB/s; against 4*D float32 operations per (query head, slot) of each
    row for QK^T and PV, over 67 TFLOP/s."""
    q, k_pages, _, bt, sl = args
    B, H, D = q.shape
    KV, N, block, _ = k_pages.shape
    walked, read = 0, set()
    for row, n_tok in zip(bt.tolist(), sl.tolist()):
        need = min(math.ceil(n_tok / block), bt.shape[1])
        need = need if n_tok > 0 else bt.shape[1]
        walked += need
        read.update(max(p, 0) for p in row[:need])
    pages = len(read)
    elt = k_pages.element_size()
    nbytes = (2 * KV * pages * block * D * elt          # K and V pages
              + (2 * KV * pages * 4 if kw else 0)       # their scales
              + 2 * q.numel() * 4                       # q in, out
              + bt.numel() * 4 + sl.numel() * 4)
    flops = 4 * (H // KV) * KV * walked * block * D     # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def time_kernel(quantized: bool, dev, launches: int, worst: dict,
                rows: int = 64) -> dict:
    """B1 at the serving shapes, ``rows`` rows of 32 full pages: held to
    its plain version, then timed by CUDA events (the wrapper's host work
    included) and by device time per call, beside its plain version, SDPA
    over the gathered K/V (fp32) and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_decode_attention import (
        ROW_GROUP, _blocks_per_sm, choose_splits, split_ranges,
        paged_decode_attention as kernel,
        paged_decode_attention_reference as plain,
    )
    args, kw = to_device(serving_case(quantized, dev, ragged=False,
                                      rows=rows), dev)
    q, k_pages, v_pages, bt, sl = args
    B, H, D = q.shape
    KV, _, block, _ = k_pages.shape
    key = "int8" if quantized else "float32"
    got, want = kernel(*args, **kw), plain(*args, **kw)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, **TOL):
        fail(f"kernel disagrees with its plain version at the timed shape "
             f"({key}, {rows} rows): max abs err {err:.3g}")
    ms, plain_ms = _time_pair(lambda: kernel(*args, **kw),
                              lambda: plain(*args, **kw))
    bound_ms, bound_by, nbytes = bound(args, kw)
    library_ms = sdpa_dev = None
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

        def sdpa():
            return F.scaled_dot_product_attention(q4, kc, vc)
        if not torch.allclose(sdpa()[:, :, 0], want, atol=1e-3, rtol=1e-3):
            fail("SDPA yardstick does not compute the kernel's function")
        library_ms = cuda_ms(sdpa)
        sdpa_dev = _device_ms_per_call(sdpa)
    dev_ms = _device_ms_per_call(lambda: kernel(*args, **kw))
    groups = B * KV * -(-(H // KV) // ROW_GROUP)
    n_splits = len(split_ranges(bt.shape[1], choose_splits(
        groups, bt.shape[1],
        torch.cuda.get_device_properties(dev).multi_processor_count,
        _blocks_per_sm(q.get_device(), quantized, D, bt.shape[1]))))
    name = "paged_decode_attention_" + ("i8" if quantized else "f32") + (
        "" if rows == 64 else f"_b{rows}")
    log(f"{name}: B={B} H={H} KV={KV} D={D} block={block} "
        f"pages/row={bt.shape[1]}, {groups} x {n_splits} blocks: max abs err "
        f"{err:.3g} (all cases {worst[key]:.3g}), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {library_ms} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}, {nbytes} B), achieved "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; device time per call "
        f"(profiler): kernel {dev_ms}, SDPA {sdpa_dev}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:164",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# -- phase 20: B1 at speculative verify's call shape ---------------------------

def time_verify(quantized: bool, dev, launches: int) -> dict:
    """B1 on ``verify_rows`` (8 requests x 5 rows on shared tables, seq_lens
    start+1 .. start+5, qwen2-0.5b's heads, 32 pages of 64 a table): held
    to the plain version and to the split rule at the rule's count, then
    timed as ``time_kernel`` times it, beside SDPA over the gathered K/V
    with a length mask (fp32).  Also the largest difference between the
    rule's split count here and the count a decode step of the same 8
    requests takes (one row each), which a verify and a stepwise decode
    of one token meet."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_decode_attention import (
        _launch, paged_decode_attention as kernel,
        paged_decode_attention_reference as plain,
        paged_decode_attention_split_reference as split_plain)
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_kernels_cuda as cases
    args, kw = to_device(cases.verify_rows(8, 4, quantized=quantized), dev)
    q, k_pages, v_pages, bt, sl = args
    B, H, D = q.shape
    KV, _, block, _ = k_pages.shape
    key = "int8" if quantized else "float32"
    n_splits = cases.rule_splits(args, quantized)
    # a decode step of the same 8 requests: one row each, same tables
    step_splits = cases.rule_splits([q[::5], k_pages, v_pages, bt[::5],
                                     sl[::5]], quantized)
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    err = (got - want).abs().max().item()
    by_rule = split_plain(*args, **kw, n_splits=n_splits)
    if not (torch.allclose(got, want, **TOL)
            and torch.allclose(got, by_rule, **TOL)):
        fail(f"kernel disagrees with its plain version or its split rule at "
             f"the verify shape ({key}): max abs err {err:.3g}, against the "
             f"rule {(got - by_rule).abs().max().item():.3g}")
    at_step = _launch(*args, **kw, n_splits=step_splits)
    split_diff = (got - at_step).abs().max().item()
    ms, plain_ms = _time_pair(lambda: kernel(*args, **kw),
                              lambda: plain(*args, **kw))
    bound_ms, bound_by, nbytes = bound(args, kw)
    library_ms = sdpa_dev = None
    if not quantized:
        # yardstick only, never called by the port: SDPA over each row's
        # gathered K/V, masked past its length
        idx = bt.long()
        kc = k_pages[:, idx].reshape(KV, B, -1, D).permute(1, 0, 2, 3)
        vc = v_pages[:, idx].reshape(KV, B, -1, D).permute(1, 0, 2, 3)
        kc = kc.repeat_interleave(H // KV, dim=1).contiguous()
        vc = vc.repeat_interleave(H // KV, dim=1).contiguous()
        mask = (torch.arange(kc.shape[2], device=dev)[None, :]
                < sl[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)
        if not torch.allclose(sdpa()[:, :, 0], want, atol=1e-3, rtol=1e-3):
            fail("SDPA yardstick does not compute the kernel's function at "
                 "the verify shape")
        library_ms = cuda_ms(sdpa)
        sdpa_dev = _device_ms_per_call(sdpa)
    dev_ms = _device_ms_per_call(lambda: kernel(*args, **kw))
    name = "paged_decode_attention_" + ("i8" if quantized else "f32") + (
        "_verify_b8x5")
    log(f"{name}: {B} rows (8 requests x 5, k 4) H={H} KV={KV} D={D} "
        f"block={block} pages/row={bt.shape[1]}, {n_splits} splits (a decode "
        f"step of the same 8 requests: {step_splits}; outputs differ by up "
        f"to {split_diff:.3g} between the two counts): max abs err "
        f"{err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B), "
        f"achieved {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; device time per "
        f"call (profiler): kernel {dev_ms}, SDPA {sdpa_dev}")
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


def model_path(dev, arch: str, kernels: dict, routes=None, *,
               prompt: int = 512, extras=None) -> dict:
    """``arch`` as published (bf16, full width): prefill 8 x ``prompt``,
    32 decode_steps, the same 32 tokens through decode_multi; ``extras``
    go to every prefill (whisper's frames).  ``kernels`` maps a name to
    (wrapper, launches wanted per prefill, per decode step); ``routes``
    maps a route of B3 to the launches wanted on it per prefill, and then
    no other route may launch in prefill.  Returns each kernel's launches
    over this run (every count set to 0 just before it, read just
    after)."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    B, S, N = 8, prompt, 32
    extras = extras or {}
    t0 = time.perf_counter()
    model = M.Model(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    # warm-up at the timed shapes (cuBLAS, the kernel library, the caching
    # allocator), not counted
    _, c = model.prefill(toks, extras)
    c = M.grow_cache(c, cfg, B, S + N)
    for i in range(4):
        model.decode_step(toks[:, :1], c, S + i)
    del c
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {n_params} parameters ({cfg.dtype}), built and "
        f"warmed in {time.perf_counter() - t0:.1f} s")

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for wrapper, _, _ in kernels.values():
        wrapper.launches = 0
    by_route = flash_attention_bhsd.launches_by_route
    for r in by_route:
        by_route[r] = 0
    start.record()
    logits, cache = model.prefill(toks, extras)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    in_prefill = {k: w.launches for k, (w, _, _) in kernels.items()}
    routes_in_prefill = dict(by_route)
    for r, launched in routes_in_prefill.items():
        if launched < (routes or {}).get(r, 0):
            fail(f"{arch}: flash kernel launched {launched} times on its "
                 f"{r} route in prefill, want >= {routes[r]}")
        if routes and r not in routes and launched:
            fail(f"{arch}: flash kernel launched {launched} times on its "
                 f"{r} route in prefill, want all on {sorted(routes)}")
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
    counts = {k: w.launches for k, (w, _, _) in kernels.items()}
    busy = {
        "prefill": device_share(lambda: model.prefill(toks, extras)),
        "decode_step x4": device_share(lambda: [
            model.decode_step(first, saved, S + i) for i in range(4)]),
    }
    stepwise = torch.stack(steps, 1)
    if not torch.equal(fused, stepwise) or int(clen) != S + N:
        fail(f"decode_multi differs from stepwise decoding: "
             f"{fused.tolist()} vs {stepwise.tolist()}")
    for k, (_, per_prefill, per_step) in kernels.items():
        if in_prefill[k] < per_prefill:
            fail(f"{arch}: {k} kernel launched {in_prefill[k]} times in "
                 f"prefill, want >= {per_prefill}")
        if counts[k] - in_prefill[k] < per_step * N:
            fail(f"{arch}: {k} kernel launched {counts[k] - in_prefill[k]} "
                 f"times in {N} decode steps, want >= {per_step * N}")
    log(f"model path {arch}: prefill {B} x {S} tokens {prefill_ms:.3f} ms; "
        f"decode {B} rows: decode_step {step_ms:.3f} ms/token, decode_multi "
        f"{multi_ms:.3f} ms/token; streams equal over {B} x {N} tokens; "
        f"launches " + ", ".join(f"{k} {counts[k]} ({in_prefill[k]} in "
                                 f"prefill)" for k in kernels)
        + f"; flash routes in prefill {routes_in_prefill}")
    for what, (wall_ms, dev_ms, n_kernels, top) in busy.items():
        share = f"{dev_ms / wall_ms:.3f}" if dev_ms else "not measured"
        log(f"profile {arch} {what}: wall {wall_ms:.3f} ms (profiler on), "
            f"device kernels {dev_ms:.3f} ms in {n_kernels} launches, busy "
            f"share {share}; top: {top}")
    del model, cache, saved
    torch.cuda.empty_cache()
    return counts


def audio_frames(dev, arch: str, batch: int) -> dict:
    """Whisper's encoder input as ``extras``: random frames [batch, 1500,
    d_model] in the model's dtype, from a seeded generator on the card
    (the conv frontend is a stub, as in the reference)."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    g = torch.Generator(dev).manual_seed(1)
    return {"frames": torch.randn(
        (batch, cfg.encdec.n_encoder_ctx, cfg.d_model), generator=g,
        device=dev).to(cfg.param_dtype())}


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


def layer_calls(arch: str, *kinds: str) -> int:
    """How many layers of these kinds one pass through ``arch`` runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_plan
    return sum(stage.n_periods for stage in build_plan(get_config(arch))
               for spec in stage.specs if spec.kind in kinds)


# -- phase 8: token identity of the model path --------------------------------

def model_token_identity(dev, arch: str, **cut) -> None:
    """``arch`` in float32 at full width (depth cut by ``cut``), the same
    weights on the card and on the CPU: one 64-token prompt, 16 greedy
    tokens; whisper's encoder takes 1,500 random frames, the same on both.

    A moe arch is held to the near-tie rule (tests/test_torch_moe_cuda.py,
    ``routing_report``): every moe layer's input is recorded on both
    devices, and its expert sets are compared call by call, in order, up
    to the first call whose sets differ; that difference must be a
    near-tie (the CPU's k-th and (k+1)-th probabilities within 1e-5), else
    the run fails.  A run with a near-tie is logged and counted and proves
    nothing about the streams, so the next prompt seed is tried, at most
    three; the first run without one must give equal streams."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.moe import MoE
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_moe_cuda import NEAR_TIE, routing_report

    cfg = get_config(arch).scaled(dtype="float32", **cut)
    S, N = 64, 16
    moe = cfg.moe is not None
    t0 = time.perf_counter()
    cpu = M.Model(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    ties = []
    for seed in ((1, 2, 3) if moe else (1,)):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
        frames = (rng.standard_normal((1, cfg.encdec.n_encoder_ctx,
                                       cfg.d_model)).astype(np.float32)
                  if cfg.family == "audio" else None)
        streams, calls = {}, {}
        for name, model in (("cuda", card), ("cpu", cpu)):
            calls[name] = []
            hooks = [m.register_forward_hook(
                lambda mod, args, out, rec=calls[name]: rec.append(
                    (mod, args[0])))
                for m in model.modules() if isinstance(m, MoE)]
            try:
                t = torch.from_numpy(toks).to(model.device)
                extras = ({} if frames is None else
                          {"frames": torch.from_numpy(frames).to(
                              model.device)})
                logits, cache = model.prefill(t, extras)
                cache = M.grow_cache(cache, cfg, 1, S + N)
                first = logits[:, 0, :cfg.vocab_size].argmax(-1).to(
                    torch.int32)
                fused, _, _ = model.decode_multi(first[:, None], cache, S, N)
            finally:
                for h in hooks:
                    h.remove()
            streams[name] = [int(first[0])] + fused[0].tolist()
        tie = None
        if len(calls["cuda"]) != len(calls["cpu"]):
            fail(f"{arch}: {len(calls['cuda'])} moe calls on the card, "
                 f"{len(calls['cpu'])} on the CPU")
        for i, ((m_card, x_card), (m_cpu, x_cpu)) in enumerate(
                zip(calls["cuda"], calls["cpu"])):
            rep = routing_report(x_card, x_cpu, m_card.router.detach(),
                                 m_cpu.router.detach(), m_cpu.dims)
            if rep["differ"] > rep["near_ties"]:
                fail(f"{arch} seed {seed}: moe call {i} of "
                     f"{len(calls['cpu'])} routes {rep['differ']} of "
                     f"{rep['tokens']} tokens to other experts on the card, "
                     f"{rep['near_ties']} of them at a near-tie "
                     f"(<= {NEAR_TIE}; smallest gap {rep['min_gap']})")
            if rep["near_ties"]:
                tie = (i, rep)
                break
        if moe:
            same = streams["cuda"] == streams["cpu"]
            log(f"model token identity {arch} seed {seed}: "
                f"{len(calls['cpu'])} moe calls compared, "
                + (f"near-tie at call {tie[0]}: {tie[1]}; streams "
                   f"{'equal' if same else 'differ'}, next seed" if tie
                   else "expert sets equal"))
        if tie:
            ties.append((seed, tie))
            continue
        if streams["cuda"] != streams["cpu"]:
            fail(f"model tokens differ between cuda and cpu: "
                 f"{streams['cuda']} vs {streams['cpu']}")
        log(f"model token identity {arch} (float32, full width"
            + (f", {cut}" if cut else "") + f"): cuda == cpu over "
            f"{len(streams['cpu'])} tokens"
            + (f", seed {seed} after {len(ties)} near-tie run(s)" if moe
               else "") + f" ({time.perf_counter() - t0:.1f} s)")
        break
    else:
        fail(f"{arch}: every prompt seed had a near-tie: {ties}")
    del card, calls
    torch.cuda.empty_cache()


# -- phase 9: B2 and B3 against their plain versions ---------------------------

def _attention_cases():
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_attention_cuda as cases
    return cases


def attention_vs_plain(dev) -> dict:
    """Worst abs error per (kernel, dtype) over the cases; fails outside
    ``KERNEL_TOLS`` (float32 atol = rtol = 2e-5; bfloat16 rtol = 2e-2 with
    atol = 8e-3 for B3 and 2e-3 for B2)."""
    import torch

    from repro_torch.kernels.decode_attention import (
        decode_attention_reference)
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd, flash_attention_reference)
    cases = _attention_cases()
    worst, excess = {}, {}
    n = 0
    for dname, dtype in cases.DTYPES.items():
        todo = ([("flash", cases.to_torch(c, dev, dtype))
                 for _, c in cases.flash_cases()]
                + [("decode", cases.to_torch(c, dev, dtype))
                   for _, c in cases.decode_cases()]
                + [("flash", cases.model_flash(dev, dtype, window=w))
                   for w in (None, 16)]
                + [("decode", cases.model_decode(dev, dtype, window=w))
                   for w in (None, 16)]
                + [("flash", cases.model_flash(dev, dtype, B=8, S=512, H=H,
                                               KV=KV))
                   for H, KV in cases.MODEL_HEADS.values()]
                + [("decode", cases.model_path_decode(dev, dtype, n, H=H,
                                                      KV=KV))
                   for H, KV in cases.MODEL_HEADS.values()
                   for n in (513, 544)]
                + [("decode", dict(cases.to_torch(c, dev, dtype),
                                   n_splits=n))
                   for _, c, n in cases.split_decode_cases()])
        if dname == "bfloat16":
            todo += [("flash", cases.wgmma_flash(dev, **p))
                     for _, p in cases.wgmma_flash_cases()]
        for kind, c in todo:
            if kind == "flash":
                got = cases.run_flash(flash_attention_bhsd, c)
                torch.cuda.synchronize()
                want = cases.run_flash(flash_attention_reference, c)
            else:
                got = cases.run_decode_splits(c, c.get("n_splits"))
                torch.cuda.synchronize()
                want = cases.run_decode(decode_attention_reference, c)
            tol = cases.KERNEL_TOLS[kind][dname]
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            over = (diff - tol["rtol"] * want.float().abs()).max().item()
            worst[(kind, dname)] = max(worst.get((kind, dname), 0.0), err)
            excess[(kind, dname)] = max(excess.get((kind, dname), -1.0), over)
            n += 1
            if not torch.allclose(got.float(), want.float(), **tol):
                fail(f"{kind} attention kernel disagrees with its plain "
                     f"version ({dname}, q {tuple(c['q'].shape)}, k "
                     f"{tuple(c['k'].shape)}, window {c['window']}): max "
                     f"abs err {err:.3g}, max of |err| - rtol |plain| "
                     f"{over:.3g}")
    log(f"B2/B3 kernel vs plain version over {n} calls: max abs err "
        + ", ".join(f"{k} {d} {e:.3g}" for (k, d), e in sorted(worst.items()))
        + "; max of |err| - rtol |plain| "
        + ", ".join(f"{k} {d} {e:.3g}" for (k, d), e in sorted(excess.items()))
        + " (fp32 atol = rtol = 2e-5; bf16 rtol = 2e-2, atol = 8e-3 flash "
        "and 2e-3 decode)")
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


# SDPA, a yardstick, is first held to the plain version at this limit: its
# own bf16 rounding met it at every timed shape on the H100 (PERF.md)
YARDSTICK_TOL = dict(atol=4e-3, rtol=2e-2)


def _held_to_plain(got, want, what: str, kind: str) -> float:
    """Max abs error of a kernel's output against its plain version on
    the same inputs; fails outside the kernel's bfloat16 ``KERNEL_TOLS``."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(),
                          **_attention_cases().KERNEL_TOLS[kind]["bfloat16"]):
        fail(f"{what}: kernel disagrees with its plain version at the timed "
             f"shape: max abs err {err:.3g}")
    return err


def _device_ms_per_call(fn, calls: int = 20) -> str:
    """Device time per call of ``fn`` from ``torch.profiler`` (device
    activity only), the host's work between launches left out (which
    back-to-back CUDA-event timing includes): for each kernel name, its
    mean time per recorded launch times its launches per call (at least
    one; the profiler can drop records), summed; "not measured" when it
    recorded no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count]
    if not kernels:
        return "not measured"
    us = sum(e.self_device_time_total / e.count * max(1, round(e.count / calls))
             for e in kernels)
    return f"{us / 1e3:.4f} ms"


def time_attention(dev, launches: dict) -> list:
    """Phase 10: B3 at 8 x 512 and 1 x 4096 with qwen2-0.5b's heads and at
    8 x 512 with zamba2-1.2b's and olmo-1b's; B2 at 64 rows x 4096 slots and
    at phase 7's 8 rows x 544 slots, qwen2-0.5b's heads; bf16."""
    out = [time_flash(dev, launches, B, S, H, KV, D)
           for B, S, H, KV, D in ((8, 512, 14, 2, 64), (1, 4096, 14, 2, 64),
                                  (8, 512, 32, 32, 64),
                                  (8, 512, 16, 16, 128))]
    out += [time_decode(dev, launches, B, Sc) for B, Sc in ((64, 4096),
                                                            (8, 544))]
    return out


def time_flash(dev, launches: dict, B, S, H, KV, D, causal=True,
               plain=None) -> dict:
    """B3 at one shape, held to ``plain`` (default: its plain version)
    on the timed inputs, then timed beside it, SDPA and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd, flash_attention_reference, route)
    plain = plain or flash_attention_reference
    cases = _attention_cases()
    c = cases.model_flash(dev, torch.bfloat16, B=B, S=S, H=H, KV=KV, D=D)
    c["causal"] = causal
    q, k, v = c["q"], c["k"], c["v"]
    got = cases.run_flash(flash_attention_bhsd, c)
    name = f"flash_attention_bf16_b{B}_s{S}" + (
        "" if (H, KV, D) == (14, 2, 64) else f"_h{H}kv{KV}d{D}") + (
        "" if causal else "_bidir")
    want = cases.run_flash(plain, c)
    err = _held_to_plain(got, want, name, "flash")

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    if not torch.allclose(sdpa().float(), want.float(),
                          **YARDSTICK_TOL):
        fail("SDPA yardstick does not compute flash attention's function")
    ms, plain_ms = _time_pair(
        lambda: cases.run_flash(flash_attention_bhsd, c),
        lambda: cases.run_flash(plain, c))
    library_ms = cuda_ms(sdpa)
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KV * D)  # q, o, k, v
    pairs = S * (S + 1) // 2 if causal else S * S           # kept pairs
    flops = 4 * D * H * B * pairs
    bound_ms, bound_by = _bound(nbytes, flops)
    which = route(torch.bfloat16, D)
    dev_ms = _device_ms_per_call(
        lambda: cases.run_flash(flash_attention_bhsd, c))
    log(f"{name}: H={H} KV={KV} D={D} "
        f"{'causal' if causal else 'bidirectional'}, {which} route: max abs "
        f"err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {nbytes} "
        f"B, {flops} flop), achieved {flops / (ms * 1e-3) / 1e12:.2f} "
        f"TFLOP/s; device time per call (profiler): kernel {dev_ms}, SDPA "
        f"{_device_ms_per_call(sdpa)}")
    source = ("flash_attention_wgmma.cu" if which == "wgmma"
              else "flash_attention.cu")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "launches": launches["flash"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def time_decode(dev, launches: dict, B, Sc, H=14, KV=2, D=64,
                case=None) -> dict:
    """B2 at one shape, every row's Sc slots valid, held to its plain
    version on the timed inputs, then timed beside it, SDPA and its bound;
    ``case`` gives the inputs (default: the tests' ``model_decode``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        ROW_GROUP, choose_splits, decode_attention_bhd,
        decode_attention_reference, split_ranges, tile_slots)
    cases = _attention_cases()
    c = case or cases.model_decode(dev, torch.bfloat16, B=B, Sc=Sc, H=H,
                                   KV=KV, D=D)
    c["cache_len"] = torch.full((B,), Sc, dtype=torch.int32, device=dev)
    got = cases.run_decode(decode_attention_bhd, c)
    name = f"decode_attention_bf16_b{B}_s{Sc}" + (
        "" if (H, KV, D) == (14, 2, 64) else f"_h{H}kv{KV}d{D}")
    want = cases.run_decode(decode_attention_reference, c)
    err = _held_to_plain(got, want, name, "decode")
    q4 = c["q"][:, :, None]                                 # [B, H, 1, D]
    mask = ((c["positions"] >= 0) & (c["positions"] < c["cache_len"][:, None])
            )[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, c["k"], c["v"],
                                              attn_mask=mask, enable_gqa=True)
    if not torch.allclose(sdpa()[:, :, 0].float(), want.float(),
                          **YARDSTICK_TOL):
        fail("SDPA yardstick does not compute decode attention's function")
    ms, plain_ms = _time_pair(
        lambda: cases.run_decode(decode_attention_bhd, c),
        lambda: cases.run_decode(decode_attention_reference, c))
    library_ms = cuda_ms(sdpa)
    nbytes = (2 * 2 * B * H * D + 2 * 2 * B * Sc * KV * D   # q, o, k, v
              + 4 * B + 4 * Sc)                             # lengths, positions
    flops = 4 * D * H * B * Sc                              # every slot kept
    bound_ms, bound_by = _bound(nbytes, flops)
    tile = tile_slots(torch.bfloat16, D)
    blocks = B * KV * -(-(H // KV) // ROW_GROUP)
    n_splits = len(split_ranges(Sc, choose_splits(
        blocks, Sc, tile, torch.cuda.get_device_properties(
            dev).multi_processor_count), tile))
    dev_ms = _device_ms_per_call(
        lambda: cases.run_decode(decode_attention_bhd, c))
    log(f"{name}: H={H} KV={KV} D={D}, {blocks} x {n_splits} blocks: max abs "
        f"err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {nbytes} "
        f"B), achieved {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; device time "
        f"per call (profiler): kernel {dev_ms}, SDPA "
        f"{_device_ms_per_call(sdpa)}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:72",
            "launches": launches["decode"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def time_whisper(dev, launches: dict) -> list:
    """B3 at whisper-small's encoder (8 x 1,500 frames, bidirectional,
    12/12 heads, D 64) and B2 at its cross-attention decode (8 rows over
    the 1,500 encoder slots, all valid), bf16, as phase 10 times B3/B2."""
    return [time_flash(dev, launches, 8, 1500, 12, 12, 64, causal=False),
            time_decode(dev, launches, 8, 1500, 12, 12, 64)]


# -- phase 11: B4 against its plain version -----------------------------------

def _scan_cases():
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_mamba_scan_cuda as cases
    return cases


def _scan_err(got, want, what: str) -> float:
    """Max abs error of (y, h_last) against the plain version's; fails
    outside atol = rtol = 1e-4."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        err = max(err, (g - w).abs().max().item())
        if not torch.allclose(g, w, atol=1e-4, rtol=1e-4):
            fail(f"{what}: scan kernel disagrees with its plain version: max "
                 f"abs err {err:.3g}")
    return err


def scan_vs_plain(dev) -> float:
    """B4 on tests/test_torch_mamba_scan_cuda.py's cases (tests/
    test_kernels.py's shapes, a ragged Di, nonzero h0, d_state 32 and 64)
    and at falcon-mamba-7b's width at T = 1 (from a state, then writing
    h_last over h0) and T = 512."""
    import torch

    from repro_torch.kernels.mamba_scan import (
        mamba1_scan, mamba1_scan_reference)
    cases = _scan_cases()
    todo = [(cases.shape_id(s), cases.to_torch(cases.scan_case(*s), dev))
            for s in cases.SHAPES]
    todo += [(f"falcon-T{T}", cases.falcon_case(dev, T, with_h0=h0))
             for T, h0 in ((1, True), (512, False))]
    worst = 0.0
    for name, c in todo:
        got = cases.run(mamba1_scan, c)
        torch.cuda.synchronize()
        worst = max(worst, _scan_err(got, cases.run(mamba1_scan_reference, c),
                                     name))
    # a decode step's form: h_last written over h0
    c = cases.falcon_case(dev, 1, with_h0=True, seed=2)
    want = cases.run(mamba1_scan_reference, c)
    h = c["h0"].clone()
    got = mamba1_scan(c["x"], c["dt"], c["Bt"], c["Ct"], c["A"], h, h)
    torch.cuda.synchronize()
    if got[1] is not h:
        fail("scan kernel did not write h_last where asked")
    worst = max(worst, _scan_err(got, want, "falcon-T1-in-place"))
    todo.append(("falcon-T1-in-place", c))
    # the design's cases: every N with its lanes per channel at T on either
    # side of the 16-step tile, and h_last over h0 at every N with 16-byte
    # (Di 256) and 4-byte (Di 130) copies
    for N, T in cases.STATE_CASES:
        c = cases.to_torch(cases.scan_case(2, T, 200, N, True), dev)
        got = cases.run(mamba1_scan, c)
        torch.cuda.synchronize()
        worst = max(worst, _scan_err(got, cases.run(mamba1_scan_reference, c),
                                     f"N{N}-T{T}"))
        todo.append((f"N{N}-T{T}", c))
    for N in (8, 16, 32, 64):
        for Di in (256, 130):
            c = cases.to_torch(cases.scan_case(3, 1, Di, N, True, seed=5), dev)
            want = cases.run(mamba1_scan_reference, c)
            h = c["h0"].clone()
            got = mamba1_scan(c["x"], c["dt"], c["Bt"], c["Ct"], c["A"], h, h)
            torch.cuda.synchronize()
            if got[1] is not h:
                fail("scan kernel did not write h_last where asked")
            worst = max(worst, _scan_err(got, want, f"N{N}-Di{Di}-in-place"))
            todo.append((f"N{N}-Di{Di}-in-place", c))
    log(f"B4 kernel vs plain version over {len(todo)} calls (y and h_last): "
        f"max abs err {worst:.3g} (atol = rtol = 1e-4)")
    return worst


# -- phase 15: B4 times -------------------------------------------------------

def time_scan(dev, launches: int) -> list:
    """B4 at phase 12's shapes: the prefill (8 x 512 from zero) and one
    decode step (8 x 1 from a state), each first held to its plain version
    on the timed inputs, then timed beside it, with its bound: the larger
    of its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s
    (no one PyTorch call computes the scan, so no library time)."""
    from repro_torch.kernels.mamba_scan import (
        mamba1_scan, mamba1_scan_reference)
    cases = _scan_cases()
    out = []
    for T, with_h0 in ((512, False), (1, True)):
        c = cases.falcon_case(dev, T, with_h0=with_h0, seed=1)
        B, _, Di = c["x"].shape
        N = c["Bt"].shape[-1]
        name = f"mamba_scan_f32_b{B}_t{T}" + ("_h0" if with_h0 else "")
        err = _scan_err(cases.run(mamba1_scan, c),
                        cases.run(mamba1_scan_reference, c), name)
        ms, plain_ms = _time_pair(lambda: cases.run(mamba1_scan, c),
                                  lambda: cases.run(mamba1_scan_reference, c))
        # x, dt read and y written; B_t, C_t; A; h0 read and h_last written
        nbytes = 4 * (3 * B * T * Di + 2 * B * T * N + Di * N
                      + (2 if with_h0 else 1) * B * Di * N)
        # per (b, t, d, n): dt*A, exp, *h, dtx*B, +, C*h, +; per (b, t, d):
        # dt*x
        flops = 7 * B * T * Di * N + B * T * Di
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        # the device's own time per call, apart from the wrapper's host
        # work between back-to-back launches (phase 10's method)
        dev_ms = _device_ms_per_call(lambda: cases.run(mamba1_scan, c))
        log(f"{name}: Di={Di} N={N}: max abs err {err:.3g}, kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {nbytes} B, {flops} flop), achieved "
            f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
            f"{B * T * Di * N / (ms * 1e-3) / 1e12:.3f} T exp/s; device time "
            f"per call (profiler): kernel {dev_ms}")
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/csrc/mamba_scan.cu",
                    "replaces": "src/repro/kernels/mamba_scan.py:48",
                    "launches": launches, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
    return out


# -- phases 25-27: the calibration, the DES on it, the contention example ---

CALIBRATED = "qwen2-0.5b"


def calibration(dev, out_dir: Path) -> dict:
    """Phase 25: ``emit_devmodel`` for qwen2-0.5b on the card as published
    (bf16; the cells prefill_32k and decode_32k, a batch halved only where
    it does not fit), B3 and B2 counted over the run (every count set to 0
    just before it, read just after); every coefficient finite and
    positive, ``measured_on`` naming this card; then the emulated serve
    run on the emitted file.  Returns the record."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_bhd
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.launch import dryrun

    flash_attention_bhsd.launches = decode_attention_bhd.launches = 0
    by_route = flash_attention_bhsd.launches_by_route
    for r in by_route:
        by_route[r] = 0
    t0 = time.perf_counter()
    rec = dryrun.emit_devmodel(CALIBRATED, out_dir, device=dev)
    wall = time.perf_counter() - t0
    flash, decode = (flash_attention_bhsd.launches,
                     decode_attention_bhd.launches)
    routes = dict(by_route)
    log(f"devmodel {json.dumps(rec)}")
    dm, on = rec["device_model"], rec["measured_on"]
    if not all(math.isfinite(v) for v in dm.values()):
        fail(f"calibration: a coefficient is not finite: {dm}")
    timed = ("t_fixed", "t_prefill_tok", "t_decode_seq", "t_block_entry",
             "t_swap_block", "max_step")
    if not all(dm[k] > 0 for k in timed):
        fail(f"calibration: a coefficient is not positive: {dm}")
    name = torch.cuda.get_device_name(dev)
    if not re.fullmatch(rf"{re.escape(name)}, \d+(\.\d+)? W",
                        on["device"]):
        fail(f"calibration measured on {on['device']!r}, want {name!r} "
             f"and its power limit in W")
    # one prefill and one decode step per call: the warm-up and REPEATS
    # timed calls, and more only where a batch was halved after running
    # out of memory part way
    want = (1 + dryrun.REPEATS) * layer_calls(CALIBRATED, "attn")
    if ((flash, decode) != (want, want) and not on["cuts"]) or min(
            flash, decode) < want or routes["wgmma"] != flash:
        fail(f"calibration launched B3 {flash} times ({routes}) and B2 "
             f"{decode} times, want {want} each, B3 all on wgmma")
    (pre_ms, pre_by), (dec_ms, dec_by) = calibration_bounds(on)
    log(f"calibration bounds: prefill {pre_ms:.3f} ms ({pre_by}), "
        f"{pre_ms / (on['prefill']['seconds'] * 1e3):.3f} of it reached; "
        f"decode step {dec_ms:.3f} ms ({dec_by}), "
        f"{dec_ms / (on['decode']['seconds'] * 1e3):.3f} of it reached")
    log(f"calibration {CALIBRATED} in {wall:.1f} s: t_prefill_tok "
        f"{dm['t_prefill_tok']!r} s from prefill {on['prefill']['batch']} x "
        f"{on['prefill']['seq_len']} in {on['prefill']['seconds']!r} s, "
        f"t_decode_seq {dm['t_decode_seq']!r} s from a decode step of "
        f"{on['decode']['batch']} rows over {on['decode']['cache_len']} "
        f"slots in {on['decode']['seconds']!r} s; cuts: "
        f"{'; '.join(on['cuts']) or 'none'}; launches B3 {flash} "
        f"({routes}), B2 {decode}")
    serve("--backend", "emulated", "--devmodel",
          str(Path(out_dir) / f"devmodel__{CALIBRATED}.json"),
          launched=False)
    return rec, calibration_kernels(dev, on, {"flash": flash,
                                              "decode": decode})


def calibration_kernels(dev, on: dict, launches: dict) -> list:
    """B3 and B2 at the calibration's sequence length, which no earlier
    phase runs, held to their plain versions on the same inputs and timed
    as phase 10 times them: B3 at batch 1 over the prefill cell's 32,768
    tokens (the grid and the index arithmetic over S are what is new;
    the plain version is computed in query chunks), B2 at the decode
    step's rows over its 32,768 slots (the cache drawn on the card)."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(CALIBRATED)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    _chunked_is_plain(dev)
    B, Sc = on["decode"]["batch"], on["decode"]["cache_len"] + 1
    g = torch.Generator(dev).manual_seed(Sc + H)
    kc, vc = (torch.randn((B, Sc, KV, D), generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn((B, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    decode = dict(q=q, k=kc.transpose(1, 2), v=vc.transpose(1, 2),
                  cache_len=torch.full((B,), Sc, dtype=torch.int32,
                                       device=dev),
                  positions=torch.arange(Sc, dtype=torch.int32,
                                         device=dev).expand(B, Sc),
                  window=None)
    return [time_flash(dev, launches, 1, on["prefill"]["seq_len"], H, KV, D,
                       plain=flash_plain_chunked),
            time_decode(dev, launches, B, Sc, H, KV, D, case=decode)]


def flash_plain_chunked(q, k, v, *, causal: bool = True, window=None,
                        chunk: int = 1024):
    """``flash_attention_reference``'s formula term for term (float32
    scores over 1/sqrt(D), the causal and window masks at NEG_INF, softmax,
    P V, cast back), ``chunk`` query rows at a time: at S 32,768 one
    head's whole score matrix is 4 GiB in float32."""
    import torch

    from repro_torch.kernels.flash_attention import NEG_INF
    shape = q.shape
    if q.dim() == 4:
        q, k, v = (t.reshape(-1, *t.shape[2:]) for t in (q, k, v))
    BH, S, D = q.shape
    r = BH // k.shape[0]
    kx = torch.repeat_interleave(k, r, dim=0).float()
    vx = torch.repeat_interleave(v, r, dim=0).float()
    kpos = torch.arange(S, device=q.device)[None, :]
    out = torch.empty((BH, S, D), dtype=q.dtype, device=q.device)
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        s = torch.einsum("hqd,hkd->hqk", q[:, lo:hi].float(), kx) / (D ** 0.5)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        mask = torch.ones((hi - lo, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
        out[:, lo:hi] = torch.einsum("hqk,hkd->hqd", torch.softmax(s, dim=-1),
                                     vx).to(q.dtype)
    return out.reshape(shape)


def _chunked_is_plain(dev) -> None:
    """``flash_plain_chunked`` against ``flash_attention_reference`` in
    float32 where the latter fits: a ragged last chunk, causal, window
    and bidirectional, atol = rtol = 1e-5."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_reference
    cases = _attention_cases()
    for causal, window in ((True, None), (True, 64), (False, None)):
        c = cases.model_flash(dev, torch.float32, B=2, S=300, window=window)
        c["causal"] = causal
        want = cases.run_flash(flash_attention_reference, c)
        got = cases.run_flash(
            lambda *a, **kw: flash_plain_chunked(*a, chunk=128, **kw), c)
        if not torch.allclose(got, want, **TOL):
            fail(f"the chunked plain flash attention is not the plain "
                 f"version (causal {causal}, window {window}): max abs err "
                 f"{(got - want).abs().max().item():.3g}")


def calibration_bounds(on: dict) -> tuple:
    """The least time of phase 25's two timed calls, each (ms, what bounds
    it): the larger of the bytes over 3.35 TB/s (every weight read once;
    the decode step also reads every slot's K and V) and the bf16
    operations over 989 TFLOP/s (2 per weight and token for the matrix
    products, 4 D per query head and kept (query, key) pair for attention,
    the logits of the last token only)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(CALIBRATED)
    meta = M.Model(cfg, device="meta")
    weights = sum(p.numel() for p in meta.parameters())
    matmul = sum(p.numel() for n, p in meta.named_parameters()
                 if p.dim() >= 2 and n not in ("embed", "lm_head"))
    n_attn = layer_calls(CALIBRATED, "attn")
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    logits = 2 * cfg.d_model * cfg.padded_vocab
    B, S = on["prefill"]["batch"], on["prefill"]["seq_len"]
    pre_ops = (2 * matmul * B * S + 4 * D * H * B * S * (S + 1) // 2 * n_attn
               + logits * B)
    pre_bytes = 2 * weights + 4 * B * S                  # weights, tokens
    B, S = on["decode"]["batch"], on["decode"]["cache_len"] + 1
    dec_ops = 2 * matmul * B + 4 * D * H * B * S * n_attn + logits * B
    dec_bytes = 2 * weights + 2 * 2 * B * S * KV * D * n_attn
    return tuple(_bound(nbytes, ops) for nbytes, ops in
                 ((pre_bytes, pre_ops), (dec_bytes, dec_ops)))


def des_sweep(device_model: dict) -> list:
    """Phase 26: the DES's attacker/victim workload (core_sweep_sim's
    defaults: 8 attackers a second of 114,000 tokens for 15 s, one victim)
    at tp 1 over tp+1 .. 16 tp cores, on ``llama8b_tp4_params`` with its
    device and the scheduler's preemption calibration replaced by phase
    25's measured ``DeviceModel``; fewer cores may never give a lower
    victim TTFT (within the reference test's 0.1%)."""
    import dataclasses

    from repro_torch.core.devmodel import DeviceModel
    from repro_torch.sim.serving import (attacker_victim_workload,
                                         llama8b_tp4_params)
    dm = DeviceModel(**device_model)
    tp = 1
    rows = []
    for cores in sorted({tp + 1, 2 * tp, 4 * tp, 8 * tp, 16 * tp}):
        p = llama8b_tp4_params(cores, tp=tp)
        p = dataclasses.replace(p, device=dm, scheduler=dataclasses.replace(
            p.scheduler, **dm.preemption_calibration()))
        res = attacker_victim_workload(
            p, attacker_rps=8.0, attacker_tokens=114_000, n_victims=1,
            duration=15.0, horizon=260.0)
        ttft = res.victim_ttfts()[0]
        rows.append((cores, ttft))
        log(f"DES on the measured DeviceModel, tp {tp}, {cores} cores: "
            f"victim TTFT {ttft!r} s, cpu saturation {res.saturation_s!r} s")
    if any(t is None for _, t in rows):
        fail(f"DES: the victim timed out: {rows}")
    for (c0, t0), (c1, t1) in zip(rows, rows[1:]):
        if t0 < t1 * 0.999:
            fail(f"DES: {c0} cores gave a lower victim TTFT ({t0} s) than "
                 f"{c1} cores ({t1} s)")
    return rows


def contention() -> dict:
    """Phase 27: ``python -m repro_torch.launch.serve_contention --backend
    torch --arch qwen2-0.5b`` (fresh workers, so their counts start at 0):
    the idle and the attacker-load run complete without a victim timeout
    and each launches B1; logs the victim's TTFT, tokenize and dequeue p95
    and each worker's start-up, and the start-up's share of the TTFT."""
    out, wall = run_module("repro_torch.launch.serve_contention",
                           "--backend", "torch", "--arch", "qwen2-0.5b")
    runs = {}
    for label in ("no-load", "attacker-load"):
        m = re.search(rf"\[{label}\] victim TTFT=([\d.]+)ms "
                      rf"tokenize=([\d.]+)ms dequeue_p95=([\d.]+)ms", out)
        workers = re.findall(rf"\[{label}\] worker\d+ startup=([\d.]+)s "
                             rf"kernel_launches=(\d+)", out)
        if not m or len(workers) != 2:
            fail(f"serve_contention printed no {label} summary")
        ttft, tok, dq = map(float, m.groups())
        startup = [float(w[0]) for w in workers]
        launches = sum(int(w[1]) for w in workers)
        if launches <= 0:
            fail(f"serve_contention {label}: B1 was never launched")
        runs[label] = {"ttft_ms": ttft, "startup_s": startup,
                       "launches": launches}
        log(f"contention {label}: victim TTFT {ttft} ms, tokenize {tok} "
            f"ms, dequeue p95 {dq} ms, worker start-up {startup} s "
            f"(share of the TTFT {max(startup) * 1e3 / ttft:.3f}), B1 "
            f"launches {launches}")
    if "degradation under attacker load" not in out:
        fail("serve_contention printed no degradation line")
    log(f"contention: {wall:.1f} s wall")
    return runs


if __name__ == "__main__":
    main()
