"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA H100 (or another sm_90a card), ``nvcc`` and this
checkout.  Phases, each of which fails the run (non-zero exit) when it
fails:

1. card: prints ``nvidia-smi``'s name and power limit;
2. build: compiles the port's CUDA kernels from ``src/repro_torch/csrc``;
3. serving: ``python -m repro_torch.launch.serve --backend torch --arch
   qwen2-0.5b --tp 2 --multi-step 4`` as a subprocess (fresh worker
   processes, so their launch counts start at 0), once in fp32 and once
   with ``--kv-dtype int8``; every request must complete, the workers'
   summed kernel launches (captured steps' replays counted) must be above
   0, and the fp32 run's k-step plans must have replayed captured graphs
   while the int8 run, whose pool keeps the per-step loop, replays none;
   the graphs each run captured and their capture time are logged;
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
   tokens, 32 ``decode_step``s, then the same 32 tokens from the same
   cache by that stepwise loop (eager) and through ``decode_multi``, a
   captured CUDA graph of one step replayed 32 times: the streams must be
   equal, the captured loop's cache ``torch.equal`` to the eager loop's,
   the logits
   finite, and the flash (B3) and decode (B2) attention kernels launched
   at least 24 and 24 x 32 times, B3's 24 prefill launches on its
   tensor-core (``wgmma``) route, a replayed call's counted B2 launches
   exactly 24 x 32; prefill, per-token decode_step and per-token eager
   and captured times with CUDA events (eager, captured, captured, eager,
   each from the prefill cache restored in place, after a first captured
   call whose capture time is logged), then the device's busy share of a
   prefill, of four decode steps and of a replayed 4-step decode_multi
   from ``torch.profiler`` (kernel time over wall time, the profiler on,
   with the CUDA events time of the same call beside it);
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
   and B2 at least 32 times per decode step; the experts' dispatch and
   combine kernels (``kernels.moe_dispatch``) 32 times each per decode
   step of 8 rows, and the prefill's 4,096 tokens on the routed kernels
   (``kernels.moe_routed``: 3 + 1 launches a layer, ``moe.PATH_CALLS``
   "routed" 32 and no other path);
22. qwen2-moe-a2.7b as published (24 layers, d_model 2048, 16/16 heads at
   D 128, 60 experts top-4 with d_ff 1408 and 4 shared experts, vocab
   151,936, untied, bf16; about 28.6 GB of weights, freed afterwards), the
   same run with 24 launches per prefill and per step (its prefill routed
   in all 24 layers);
23. the encoder-decoder path: whisper-small as published (12 encoder and
   12 decoder layers, d_model 768, 12/12 heads at D 64, vocab 51,865,
   bf16), 8 x 1,500 random frames for its encoder, a decoder prompt of
   8 x 64 tokens and 32 steps (96 positions, within its 448); B3 launched
   at least 24 times per prefill (12 bidirectional over the frames, 12
   causal), all on ``wgmma``, and B2 at least 24 times per step (12
   self-attention, 12 cross over the 1,500 slots);
24. B3 at whisper-small's encoder shape (8 x 1,500, bidirectional) and B2
   at its cross-attention decode (8 rows x 1,500 slots) held to their plain
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
   itself first held to the plain version at a small shape) at the
   bf16 ``KERNEL_TOLS`` of tests/test_torch_attention_cuda.py and timed as
   phase 10 times them;
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

30. training at full width: ``python -m repro_torch.launch.train --arch
   qwen2-0.5b --scale full --batch 8 --seq 512`` for 6 steps with a
   checkpoint every 3, then to step 9 with ``--resume auto`` (run with the
   serve runs, before this process touches the card): both exit 0, the
   second resumes from step 6 and reaches step 9, every loss is finite and
   step 9's is below step 1's, each process launched B3 forward and
   backward at least 24 times per step; then in process, qwen2-0.5b and
   falcon-mamba-7b cut to 8 of its 64 layers (AdamW's float32 master, m
   and v at full depth need about 116 GB), bf16, 8 x 512 tokens: the
   median of three steps by CUDA events, tokens/s, peak allocated memory,
   the busy share of one step (``torch.profiler``), B3 (or B4) forward and
   backward launched 24 (or 8) times a step, B3's backward all on its
   tensor-core (``wgmma``) route;
32. the backward kernels' times: B3's at 8 x 512 with qwen2-0.5b's heads
   (bf16, causal) and at whisper's 8 x 1,500 (bidirectional), both on the
   ``wgmma`` route, B4's at 8 x 512 x 8,192 x 16 from the forward's
   checkpoints; each held to its plain version, then timed as phase 10
   times kernels, with SDPA's backward as B3's yardstick;
33. the serving leaf's k-step call (run after phase 10; 8 rows, k 4,
   qwen2-0.5b's widths) timed eager, captured, captured, eager on the host
   clock (it ends in its host read), and that saving a step set against
   the captures and replays of phase 3's fp32 serve run;

34. the dry-run on the card's host (run after the build, before the serve
   runs; it needs no card): ``python -m repro_torch.launch.dryrun`` as
   five subprocesses at once, qwen2-0.5b ``decode_32k`` and ``train_4k``,
   granite-moe-3b-a800m ``prefill_32k`` (the moe's a2a body) and
   falcon-mamba-7b ``prefill_32k`` on ``pod_16x16``, and qwen2-0.5b
   ``decode_32k`` with ``--multi-pod``; each must exit 0 and print its OK
   line, and its record (``build/dryrun``) must be ``ok`` with FLOPs,
   bytes, collectives and memory a device above 0; the log gives each
   record's numbers and its dominant roofline term on the H100 spec
   (datasheet figures, ``repro_torch.roofline.model.H100_SXM``);
35. the placed model path (after phase 32): qwen2-0.5b as published (bf16)
   under a world-size-1 NCCL process group, its parameters placed as
   DTensors on a (1, 1) ("data", "model") mesh (``place_params``), prefill
   8 x 512 and 8 ``decode_step``s from the grown, placed cache; the tokens
   and B3's and B2's launch counts must equal, bit for bit, those of the
   same model with no mesh (the kernels run through ``kernels.ops``' local
   regions), and the log says whether the prefill logits are equal too;
36. B3, B2 and B4 at the local shapes one rank of ``pod_16x16`` gives them
   (``head_layout(..., tp=16)``, dp 16): B3 at qwen2-0.5b's
   ``prefill_32k`` (2 x 32,768, 1 query head and 1 kv group, causal; held
   to the chunked plain version), B2 at its ``decode_32k`` (8 rows over
   the rank's 2,048 of 32,768 slots, all 16 padded heads over 2 kv heads,
   writing the log-sum-exp by which the ranks merge, as ``kernels.ops``
   calls it on a slot-sharded cache; the merge's collectives need ranks
   and are not timed),
   B4 at falcon-mamba-7b's ``prefill_32k`` (2 x 32,768 x 512 channels of
   8,192, d_state 16; held to its plain version at 2,048 steps, whose
   per-step loop would take seconds at 32,768, and the plain version
   timed once at the full length); each timed beside its plain version
   and its bound as phases 10 and 15 time them; B3's and B2's launches are
   phase 35's, B4's phase 12's;
37. the experts' dispatch and combine kernels (after phases 21-22 and
   38).  The decode-sized ones (``kernels.moe_dispatch``): one moe layer
   at granite-moe's widths over 64 and 8 tokens (the decode steps of the
   gen-decode and gen-prefill cells) and qwen2-moe-a2.7b's over 64, bf16:
   the fused layer held to the plain one on the timed inputs (two bf16
   steps, ``tests/test_torch_moe_cuda.py``'s limit; that error is the
   entries' ``max_abs_err``); then each kernel timed at those shapes
   beside its plain counterpart (``_route`` and ``_bucket``, router
   product included, for the dispatch; ``_combine`` for the combine) and
   its bound (bytes over 3.35 TB/s); then the whole layer, plain path
   against fused, each captured in a CUDA graph and timed over 300
   replays, at granite-moe's 8, 64, 128 and 256 tokens and qwen2-moe's
   64, 128, 256 and 512 (up to ``MAX_ASSIGNMENTS``, the fused path's
   limit), and the fused layer must be the faster at each.  The routed
   ones (``kernels.moe_routed``) at the cells' shapes: granite-4.0-h's
   widths over 65,536 tokens (gen-hybrid-16k's prefill) and 4 (its
   decode step), granite-moe's over 32,640 (gen-prefill's prefill) and
   16,384 (gen-decode's), bf16: the routed layer held to the plain one
   on the timed inputs as above; the whole layer, plain against routed,
   as a replayed graph at 4 tokens and eagerly by CUDA events (best of
   two rounds of five) at the prefills, the routed layer the faster at
   each; then the dispatch (route, offsets and fill; its three kernels'
   device time each) and the combine, each timed beside its plain
   counterpart and its bound as above;
38. granite-4.0-h-small's first pipeline stage (port-only: layers 0-19,
   18 Mamba-2 and 2 NoPE attention layers, 72 experts top-10 and a shared
   expert each; bf16, every width as published, 16.3 B parameters) at
   portbench's gen-hybrid-16k shapes, run first on the card (its
   prefill's ~59 GiB peak wants an unfragmented allocator):
   ``Model.prefill`` over 4 x 16,384 tokens, then 64 tokens by the
   captured ``decode_multi`` and by the stepwise loop, tokens and caches
   equal; the launch counts set to 0 before the prefill and read: B3 2 on
   ``wgmma`` in the prefill, B2 2 a replayed step, the decode-sized moe
   kernels none, the routed ones 3 + 1 a layer in the prefill and in each
   replayed step, ``moe.PATH_CALLS`` "routed" 20 of 20 in the prefill and
   a multiple of 20 in ``decode_multi``'s capture (no other path), the
   SSD kernel 18 in the prefill and none in decode, Mamba-2 18 calls,
   18 x 64 SSD chunks and 18 SSDs on the kernel; then B3 at 4 x 16,384
   (held to the chunked plain version) and B2 at 4 rows over 16,448
   slots, GQA 32/8 at D 128, held to their plain versions and timed as
   phase 10 times them; then the SSD kernel at one
   layer of the prefill (4 x 16,384, 128 heads of 64, d_state 128),
   held to the plain path against a float64 evaluation by the card
   test's rule and timed beside it, its two bounds (this design's, float32
   FMAs on CUDA cores at 67 TFLOP/s; and float32 accuracy on the tensor
   cores by 3xTF32) and each of its four passes' device
   time.
40. DeepSeek-V2-Lite whole (port-only: 27 layers of multi-head latent
   attention, layer 0 a dense SwiGLU, layers 1-26 64 experts top-6 with
   the gates not renormalised and 2 ungated shared experts; bf16, every
   width as published, 15.71 B parameters) at portbench's gen-mla-32k
   shapes, right after phase 38: ``Model.prefill`` over 4 x 32,768
   tokens, then 128 tokens by the captured ``decode_multi`` and by the
   stepwise loop, tokens and latent caches equal; the launch counts set
   to 0 before the prefill and read: B3 27 on ``wgmma`` (the padded
   decompressed attention) in the prefill, none in decode, B2 none, the
   routed moe kernels 3 + 1 a layer of 26 in the prefill, the decode
   ones 1 + 1 a layer in each replayed step; ``moe.PATH_CALLS`` routed 26
   in the prefill and fused alone in the capture; ``mla.MLA_COUNTS`` 27
   decompressed and 27 padded calls in the prefill, absorbed calls a
   multiple of 27 in the capture; then, the model freed, B3 at the
   prefill's padded shape (4 x 32,768, 16 heads at 256; held to the
   chunked plain version of the padded call), its bound on the needed
   work (pairs at 192 / 128) and on the executed (256 / 256), the whole
   padded call with its copies, and the absorbed decode attention at the
   last step's 32,896 slots, held to a float32 decompressed evaluation
   and timed beside its bound (the latent cache read once) and its
   executed bytes (``c_kv`` read twice).

39. the card tests (run with the serve runs, before this process touches
   the card): ``python -m pytest -q --noconftest -m cuda`` over every
   ``tests/test_torch_*_cuda.py`` as a subprocess; the log gives the
   passed, failed and skipped counts, and a failed test or none passed
   fails the run.  Each check that holds a kernel or a path to its plain
   version, or the card's output to the CPU's, is one of those tests:
   the phases above keep only what a test cannot hold (the card, the
   build, subprocess runs, full-size models and their launch counts,
   times, the calibration, the DES and the placed run).

Each phase's wall time is logged.

The line before the last is the ``kernels`` JSON (B1-B4, as timed in the
phases above, and the backward kernels ``B3-bwd``, whose entries name the
route their launch counts moved on as ``kernel_route``, and ``B4-bwd``,
and phase 36's B3, B2 and B4 at one rank's shapes of ``pod_16x16``;
phase 37's dispatch and combine, decode-sized and routed, whose entries
carry the whole layer's times, plain and fused or routed, as
``layer_ms``; phase 38's
B3, B2 and the SSD kernel at granite-4.0-h's shapes; and phase 40's B3
padded and the absorbed decode attention at DeepSeek-V2-Lite's); the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
TOL = dict(atol=1e-5, rtol=1e-5)
SERVE_TIMEOUT_S = 420
CARD_TESTS_TIMEOUT_S = 1800


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# -- phases 3 and 16-18: the serving path, in subprocesses --------------------

COMPOSITE = ("handoffs", "handoff_blocks", "spec_steps", "drafted",
             "accepted")


def run_module(module: str, *args: str,
               timeout: float = SERVE_TIMEOUT_S) -> tuple:
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
        out, _ = proc.communicate(timeout=timeout)
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
    replays = sum(int(n) for n in re.findall(r"graph_replays=(\d+)", out))
    captures = sum(int(n) for n in re.findall(r"graph_captures=(\d+)", out))
    capture_s = sum(float(x) for x in
                    re.findall(r"graph_capture_s=([\d.]+)", out))
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
           "replica_launches": launches, "graph_replays": replays,
           "graph_captures": captures, "graph_capture_s": capture_s,
           "wall_s": wall,
           "ttft_p50_ms": float(ttft.group(1)) if ttft else None,
           "counters": counters,
           "per_replica": ([int(n) for n in per_replica.group(1).split(",")]
                           if per_replica else None)}
    log(f"serve {what}: {n_done}/{n_req} requests, {sum(launches)} kernel "
        f"launches {launches}, {captures} graphs captured in "
        f"{capture_s * 1e3:.3f} ms (host, summed over the workers), "
        f"{replays} graph replays, TTFT p50 "
        f"{run['ttft_p50_ms']} ms, "
        f"{wall:.1f} s wall, counters {counters}"
        + (f", per-replica requests {run['per_replica']}"
           if per_replica else ""))
    return run


@contextlib.contextmanager
def phase(label: str):
    """Log the wall seconds of the phases in the block."""
    t0 = time.perf_counter()
    yield
    log(f"phase {label} took {time.perf_counter() - t0:.1f} s")


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
    with phase("2 (build)"):
        lib = _build.build_library()
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Function properties" \
                in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")

    # 34. the dry-run, on the host, before the serve runs
    with phase("34 (dry-run cells)"):
        dryrun_cells()

    # 3. serving, before this process touches the card's memory
    with phase("3 (serve torch fp32 and int8, --multi-step 4)"):
        fp32_run = serve("--backend", "torch", "--multi-step", "4")
        int8_run = serve("--backend", "torch", "--kv-dtype", "int8",
                         "--multi-step", "4")
    if fp32_run["graph_replays"] <= 0 or int8_run["graph_replays"]:
        fail(f"serve --multi-step 4 replayed {fp32_run['graph_replays']} "
             f"captured steps in fp32 (want > 0) and "
             f"{int8_run['graph_replays']} in int8 (want 0: its pool keeps "
             f"the per-step loop)")
    # 16.-18. the serving compositions, also before this process touches
    # the card's memory
    with phase("16 (serve hybrid fp32 and int8)"):
        hybrid = ("--backend", "hybrid", "--prefill-backend", "torch",
                  "--decode-backend", "cpu")
        for run in (serve(*hybrid), serve(*hybrid, "--kv-dtype", "int8")):
            if run["counters"].get("handoffs", 0) < 2 * 8:
                fail(f"hybrid serve handed off {run['counters']}, want each "
                     f"of 8 requests on each of 2 workers")
    with phase("17 (serve speculative fp32 and int8)"):
        speculative = ("--backend", "torch", "--speculative-k", "4",
                       "--draft-backend", "cpu")
        spec_runs = {"float32": serve(*speculative),
                     "int8": serve(*speculative, "--kv-dtype", "int8")}
        for run in spec_runs.values():
            if run["counters"].get("spec_steps", 0) <= 0:
                fail("speculative serve ran no speculative step")
    with phase("18 (serve fleet)"):
        fleet = serve("--backend", "torch", "--replicas", "2", "--routing",
                      "affinity", tp=1)
        if len(fleet["replica_launches"]) != 2:
            fail(f"fleet serve reported {fleet['replica_launches']} "
                 f"replicas")
    # 27. the attacker/victim example on TorchBackend, also before this
    # process touches the card's memory
    with phase("27 (serve_contention)"):
        contention()
    # 30. the training CLI, also before this process touches the card
    with phase("30 (launch.train, two runs)"):
        train_cli()
    # 39. the card tests, also before this process touches the card
    with phase("39 (card tests)"):
        card_tests()

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 38. granite-4.0-h's first stage at gen-hybrid-16k's shapes, first on
    # the card: its prefill's ~59 GiB peak wants an unfragmented allocator
    with phase("38 (granite-4.0-h-small, 20 layers, 4 x 16,384)"):
        hybrid_entries, hybrid_launches = hybrid_path(dev)
    # 40. DeepSeek-V2-Lite whole at gen-mla-32k's shapes: 31.4 GB of
    # weights beside its prefill, so early too
    with phase("40 (DeepSeek-V2-Lite, 27 layers, 4 x 32,768)"):
        mla_entries = mla_path(dev)

    # 6. times at the serving shapes
    with phase("6 (B1 times)"):
        entries = [time_kernel(quantized, dev, run["launches"], rows)
                   for rows in (64, 8)
                   for quantized, run in ((False, fp32_run),
                                          (True, int8_run))]
    # 20. B1 at speculative verify's call shape
    with phase("20 (B1 at the verify shape)"):
        entries += [time_verify(quantized, dev, spec_runs[key]["launches"])
                    for quantized, key in ((False, "float32"),
                                           (True, "int8"))]

    # 7.-10. the model path of the attention-only archs, B3 and B2
    from repro_torch.kernels.decode_attention import decode_attention_bhd
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.mamba_scan import mamba1_scan
    with phase("7 (qwen2-0.5b)"):
        n = layer_calls("qwen2-0.5b", "attn")
        launches = model_path(dev, "qwen2-0.5b", {
            "flash": (flash_attention_bhsd, n, 0),
            "decode": (decode_attention_bhd, 0, n)}, routes={"wgmma": n})
    with phase("10 (B2, B3 times)"):
        entries += time_attention(dev, launches)
    # 33. the serving leaf's k-step call, eager and captured
    with phase("33 (serving leaf k-step call)"):
        leaf_call_times(dev, fp32_run)

    # 12.-15. the state-space path, B4 (and B3/B2 in zamba2's shared block)
    with phase("12 (falcon-mamba-7b)"):
        n = layer_calls("falcon-mamba-7b", "ssm")
        ssm_launches = model_path(dev, "falcon-mamba-7b",
                                  {"scan": (mamba1_scan, n, n)})
    with phase("13 (zamba2-1.2b)"):
        n = layer_calls("zamba2-1.2b", "shared_attn")
        model_path(dev, "zamba2-1.2b",
                   {"flash": (flash_attention_bhsd, n, 0),
                    "decode": (decode_attention_bhd, 0, n)},
                   routes={"wgmma": n})
    with phase("15 (B4 times)"):
        entries += time_scan(dev, ssm_launches["scan"])

    # 21.-24. the moe and encoder-decoder paths, B3 and B2 at whisper's
    # shapes
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
    from repro_torch.kernels.moe_routed import (
        moe_routed_combine, moe_routed_dispatch)
    moe_launches = {}
    for i, arch in ((21, "granite-moe-3b-a800m"), (22, "qwen2-moe-a2.7b")):
        with phase(f"{i} ({arch})"):
            n, m = layer_calls(arch, "attn"), moe_layer_calls(arch)
            moe_launches[arch] = model_path(
                dev, arch, {"flash": (flash_attention_bhsd, n, 0),
                            "decode": (decode_attention_bhd, 0, n),
                            "moe_dispatch": (moe_dispatch, 0, m),
                            "moe_combine": (moe_combine, 0, m),
                            "moe_routed_dispatch": (moe_routed_dispatch,
                                                    3 * m, 0),
                            "moe_routed_combine": (moe_routed_combine, m,
                                                   0)},
                routes={"wgmma": n}, prefill_paths={"routed": m})
    with phase("23 (whisper-small)"):
        enc, dec = (layer_calls("whisper-small", kind)
                    for kind in ("enc_attn", "dec_attn"))
        whisper = model_path(
            dev, "whisper-small",
            {"flash": (flash_attention_bhsd, enc + dec, 0),
             "decode": (decode_attention_bhd, 0, 2 * dec)},  # self and cross
            routes={"wgmma": enc + dec}, prompt=64,
            extras=audio_frames(dev, "whisper-small", 8))
    with phase("24 (whisper's kernels)"):
        entries += time_whisper(dev, whisper)

    # 25.-26. the calibration on the card, then the DES on its coefficients
    with phase("25 (calibration)"):
        rec, long_kernels = calibration(dev, ROOT / "build" / "devmodel")
        entries += long_kernels
    with phase("26 (DES sweep)"):
        des_sweep(rec["device_model"])
    # 30., 32. training in process, the backward kernels' times
    with phase("30, 32 (training)"):
        entries += training(dev)
    # 35.-36. the model path placed on a mesh, the kernels at one rank's
    # shapes of the production mesh
    with phase("35 (qwen2-0.5b placed on a (1, 1) mesh)"):
        mesh_launches = mesh_path(dev)
    with phase("36 (B3, B2, B4 at pod_16x16's local shapes)"):
        entries += local_kernels(dev, mesh_launches, ssm_launches["scan"])
    # 37. the experts' dispatch and combine, decode-sized and routed
    with phase("37 (moe dispatch and combine)"):
        entries += moe_kernels(dev, moe_launches)
        entries += routed_kernels(dev, {**moe_launches,
                                        HYBRID_ARCH: hybrid_launches})
    entries += hybrid_entries + mla_entries
    log(f"the run took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def card_cases(name: str):
    """The card tests' module ``name`` (``tests/``), for the inputs and
    limits of the phases' timed calls."""
    import importlib
    sys.path.insert(0, str(ROOT / "tests"))
    return importlib.import_module(name)


# -- phase 6: B1 at the serving shapes ---------------------------------------

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
    return (*_bound(nbytes, flops, FP32_FLOPS), nbytes)


def time_kernel(quantized: bool, dev, launches: int, rows: int = 64) -> dict:
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
        f"{err:.3g}, kernel {ms:.4f} ms, plain "
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
    cases = card_cases("test_torch_kernels_cuda")
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
               prompt: int = 512, extras=None, prefill_paths=None) -> dict:
    """``arch`` as published (bf16, full width): prefill 8 x ``prompt``,
    then 32 tokens by the stepwise ``decode_step`` loop (eager) and by
    decode_multi, whose step is a captured CUDA graph replayed
    (``kernels._graph``): the first captured call (warm-up, capture,
    replays) is timed on its own, then the two loops by CUDA events in the
    order eager, captured, captured, eager, each from the prefill cache
    restored with ``copy_`` (so the captured calls replay); tokens and
    every cache tensor of the two must be ``torch.equal``, and the
    captured call's launches (replays only) must be exactly the per-step
    count of ``kernels`` times 32.  Then the
    busy share of a prefill, of four eager decode_steps and of a replayed
    4-step decode_multi.  ``extras`` go to every prefill (whisper's
    frames).  ``kernels`` maps a name to (wrapper, launches wanted per
    prefill, per decode step); ``routes`` maps a route of B3 to the
    launches wanted on it per prefill, and then no other route may launch
    in prefill; ``prefill_paths`` maps a moe path to the rise of its
    ``moe.PATH_CALLS`` entry the timed prefill must show, the others
    unmoved.  Returns each kernel's launches over this run (every count
    set to 0 just before it, read just after)."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    import numpy as np
    import torch

    from repro_torch.models.moe import PATH_CALLS

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    graph_cases = card_cases("test_torch_graph_cuda")

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
    paths0 = dict(PATH_CALLS)
    start.record()
    logits, cache = model.prefill(toks, extras)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    paths = {k: v - paths0[k] for k, v in PATH_CALLS.items() if v != paths0[k]}
    if prefill_paths is not None and paths != prefill_paths:
        fail(f"{arch}: the prefill's moe layers took the paths {paths}, "
             f"want {prefill_paths}")
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
    steps = torch.stack(steps, 1)

    # decode_multi: the first captured call (warm-up, capture, replays),
    # then the stepwise loop and decode_multi in the order eager,
    # captured, captured, eager, from the same cache
    graph_c, eager_c = _clone(saved), _clone(saved)
    start.record()
    captured, _, clen = model.decode_multi(first, graph_c, S, N)
    end.record()
    torch.cuda.synchronize()
    first_call_ms = start.elapsed_time(end)
    graphs = model.graphs
    capture_s = graphs.capture_s
    multi_ms, outs, replay_counts = [], [], None
    for graph in (False, True, True, False):
        c = graph_c if graph else eager_c
        graph_cases.restore(c, saved)
        before = {k: w.launches for k, (w, _, _) in kernels.items()}
        torch.cuda.synchronize()
        start.record()
        if graph:
            fused, _, clen_i = model.decode_multi(first, c, S, N)
        else:
            fused, clen_i = graph_cases.stepwise(model, first, c, S, N), S + N
        end.record()
        torch.cuda.synchronize()
        multi_ms.append(start.elapsed_time(end) / N)
        outs.append((graph, fused, int(clen_i)))
        if graph:
            replay_counts = {k: w.launches - before[k]
                             for k, (w, _, _) in kernels.items()}
    if graphs.captures != 1:
        fail(f"{arch}: decode_multi captured {graphs.captures} graphs over "
             f"one cache storage, want 1")
    for graph, fused, n in [(True, captured, int(clen))] + outs:
        if not torch.equal(fused, steps) or n != S + N:
            fail(f"{arch}: {'decode_multi' if graph else 'the eager loop'} "
                 f"differs from stepwise decoding: {fused.tolist()} vs "
                 f"{steps.tolist()}")
    differ = graph_cases.unequal_leaves(graph_c, eager_c)
    if differ:
        fail(f"{arch}: the captured decode_multi's cache differs from the "
             f"eager loop's in {differ}")
    for k, (_, _, per_step) in kernels.items():
        if replay_counts[k] != per_step * N:
            fail(f"{arch}: {k} kernel counted {replay_counts[k]} launches "
                 f"over {N} replayed steps, want {per_step} a step")
    counts = {k: w.launches for k, (w, _, _) in kernels.items()}
    c4 = _clone(saved)
    model.decode_multi(first, c4, S, 4)                   # its capture
    busy = {
        "prefill": device_share(lambda: model.prefill(toks, extras)),
        "decode_step x4": device_share(lambda: [
            model.decode_step(first, saved, S + i) for i in range(4)]),
        "decode_multi x4 replayed": device_share(
            lambda: model.decode_multi(first, c4, S, 4)),
    }
    for k, (_, per_prefill, per_step) in kernels.items():
        if in_prefill[k] < per_prefill:
            fail(f"{arch}: {k} kernel launched {in_prefill[k]} times in "
                 f"prefill, want >= {per_prefill}")
        if counts[k] - in_prefill[k] < per_step * N:
            fail(f"{arch}: {k} kernel launched {counts[k] - in_prefill[k]} "
                 f"times in {N} decode steps, want >= {per_step * N}")
    eager_ms = (multi_ms[0] + multi_ms[3]) / 2
    graph_ms = (multi_ms[1] + multi_ms[2]) / 2
    log(f"model path {arch}: prefill {B} x {S} tokens {prefill_ms:.3f} ms; "
        f"decode {B} rows: decode_step {step_ms:.3f} ms/token; stepwise "
        f"loop and decode_multi eager, captured, captured, eager "
        + ", ".join(f"{ms:.3f}" for ms in multi_ms)
        + f" ms/token (eager {eager_ms:.3f}, captured {graph_ms:.3f}, "
        f"{eager_ms / graph_ms:.2f}x); first captured call {first_call_ms:.3f} "
        f"ms of which capture {capture_s * 1e3:.1f} ms (host); "
        f"{len(graphs)} graphs held; streams equal over {B} x {N} tokens, "
        f"captured caches equal to eager; launches "
        + ", ".join(f"{k} {counts[k]} ({in_prefill[k]} in prefill, "
                    f"{replay_counts[k]} in a replayed call)" for k in kernels)
        + f"; flash routes in prefill {routes_in_prefill}; moe paths in "
        f"prefill {paths}")
    for what, (wall_ms, dev_ms, n_kernels, top, ev_ms) in busy.items():
        share = f"{dev_ms / wall_ms:.3f}" if dev_ms else "not measured"
        log(f"profile {arch} {what}: wall {wall_ms:.3f} ms, events "
            f"{ev_ms:.3f} ms (profiler on), device kernels {dev_ms:.3f} ms "
            f"in {n_kernels} launches, busy share {share} of the wall; top: "
            f"{top}")
    del model, cache, saved, graph_c, eager_c, c4, graphs
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
    kernel count, the four largest kernels by device time, the ms between
    CUDA events recorded before and after ``fn`` in the same call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    return (wall_ms, dev_us / 1e3, sum(e.count for e in kernels),
            [(e.key[:60], round(e.self_device_time_total / 1e3, 4), e.count)
             for e in top], start.elapsed_time(end))


def layer_calls(arch: str, *kinds: str) -> int:
    """How many layers of these kinds one pass through ``arch`` runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_plan
    return sum(stage.n_periods for stage in build_plan(get_config(arch))
               for spec in stage.specs if spec.kind in kinds)


def moe_layer_calls(arch: str) -> int:
    """How many layers of ``arch`` run the experts in one pass."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_plan
    return sum(stage.n_periods for stage in build_plan(get_config(arch))
               for spec in stage.specs if spec.moe)


# -- phase 33: the serving leaf's k-step call ---------------------------------

def leaf_call_times(dev, serve_run: dict) -> None:
    """Phase 33: the serving leaf's k-step call (8 rows, k 4, qwen2-0.5b's
    widths) timed eager and captured, and what its saving a step makes of
    the captures and replays of phase 3's fp32 serve run
    (``serve_run``)."""
    import torch
    cases = card_cases("test_torch_graph_cuda")

    graph_be, eager_be = cases.leaf_pair(dev)
    args = cases.loop_inputs(8, 4, cases.NUM_BLOCKS, seed=2)
    graph_be._decode_multi(*args, 4)                       # its capture
    eager_be._decode_multi(*args, 4)
    # the call ends in its host read: eager, captured, captured, eager, the
    # median of 20 calls each
    call_ms = []
    for be in (eager_be, graph_be, graph_be, eager_be):
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            be._decode_multi(*args, 4)
            walls.append((time.perf_counter() - t0) * 1e3)
        call_ms.append(sorted(walls)[10])
    log(f"serving leaf k-step call (8 rows, k 4, qwen2-0.5b's widths): "
        f"eager, captured, captured, eager "
        + ", ".join(f"{ms:.3f}" for ms in call_ms) + " ms a call (host "
        f"clock, median of 20)")
    saved_ms = ((call_ms[0] + call_ms[3]) - (call_ms[1] + call_ms[2])) / 8
    log(f"serve fp32 --multi-step 4 (phase 3): {serve_run['graph_captures']} "
        f"graphs captured in {serve_run['graph_capture_s'] * 1e3:.3f} ms "
        f"(host), {serve_run['graph_replays']} steps replayed; at this "
        f"bucket's saving of {saved_ms:.3f} ms a step the replays saved "
        f"about {serve_run['graph_replays'] * saved_ms:.3f} ms (an estimate: "
        f"the serve run's buckets differ from this one)")
    del graph_be, eager_be
    torch.cuda.empty_cache()


# -- phase 10: B2 and B3 times --------------------------------------------------

def _bound(nbytes: float, flops: float, flops_per_s=None) -> tuple:
    """Least time in ms of a call that moves ``nbytes`` through the H100's
    memory and does ``flops`` at ``flops_per_s`` (default its bf16
    tensor-core peak; ``repro_torch.roofline.model.H100_SXM``), and which
    of the two bounds it."""
    from repro_torch.roofline.model import H100_SXM
    t_bytes = nbytes / H100_SXM.hbm_bw * 1e3
    t_ops = flops / (flops_per_s or H100_SXM.peak_flops) * 1e3
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
    tol = card_cases("test_torch_attention_cuda").KERNEL_TOLS[kind]
    if not torch.allclose(got.float(), want.float(), **tol["bfloat16"]):
        fail(f"{what}: kernel disagrees with its plain version at the timed "
             f"shape: max abs err {err:.3g}")
    return err


def _device_ms_by_kernel(fn, calls: int = 20) -> dict:
    """Device time per call of ``fn`` from ``torch.profiler`` (device
    activity only), the host's work between launches left out (which
    back-to-back CUDA-event timing includes), by kernel name: its mean
    time per recorded launch times its launches per call (at least one;
    the profiler can drop records); {} when it recorded no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count
            * max(1, round(e.count / calls)) / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def _device_ms_per_call(fn, calls: int = 20) -> str:
    """``_device_ms_by_kernel`` summed over the kernels, or "not
    measured"."""
    by_kernel = _device_ms_by_kernel(fn, calls)
    return (f"{sum(by_kernel.values()):.4f} ms" if by_kernel
            else "not measured")


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
    cases = card_cases("test_torch_attention_cuda")
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
                case=None, with_lse: bool = False) -> dict:
    """B2 at one shape, every row's Sc slots valid, held to its plain
    version on the timed inputs, then timed beside it, SDPA and its bound;
    ``case`` gives the inputs (default: the tests' ``model_decode``).
    With ``with_lse`` the calls are those of a slot-sharded cache's rank
    (``kernels.ops``): B2 also writes each row's log-sum-exp, which is
    held to the plain version's too."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        ROW_GROUP, choose_splits, decode_attention_bhd,
        decode_attention_reference, split_ranges, tile_slots)
    cases = card_cases("test_torch_attention_cuda")
    c = case or cases.model_decode(dev, torch.bfloat16, B=B, Sc=Sc, H=H,
                                   KV=KV, D=D)
    c["cache_len"] = torch.full((B,), Sc, dtype=torch.int32, device=dev)
    kw = {"with_lse": True} if with_lse else {}
    got = cases.run_decode(decode_attention_bhd, c, **kw)
    name = f"decode_attention_bf16_b{B}_s{Sc}" + (
        "" if (H, KV, D) == (14, 2, 64) else f"_h{H}kv{KV}d{D}") + (
        "_lse" if with_lse else "")
    want = cases.run_decode(decode_attention_reference, c, **kw)
    if with_lse:
        err = max(_held_to_plain(got[1], want[1], f"{name} lse", "decode"),
                  _held_to_plain(got[0], want[0], name, "decode"))
        want = want[0]
    else:
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
        lambda: cases.run_decode(decode_attention_bhd, c, **kw),
        lambda: cases.run_decode(decode_attention_reference, c, **kw))
    library_ms = cuda_ms(sdpa)
    nbytes = (2 * 2 * B * H * D + 2 * 2 * B * Sc * KV * D   # q, o, k, v
              + 4 * B + 4 * Sc                              # lengths, positions
              + (4 * B * H if with_lse else 0))             # lse
    flops = 4 * D * H * B * Sc                              # every slot kept
    bound_ms, bound_by = _bound(nbytes, flops)
    tile = tile_slots(torch.bfloat16, D)
    blocks = B * KV * -(-(H // KV) // ROW_GROUP)
    n_splits = len(split_ranges(Sc, choose_splits(
        blocks, Sc, tile, torch.cuda.get_device_properties(
            dev).multi_processor_count), tile))
    dev_ms = _device_ms_per_call(
        lambda: cases.run_decode(decode_attention_bhd, c, **kw))
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


# -- phase 15: B4 times -------------------------------------------------------

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


def time_scan(dev, launches: int) -> list:
    """B4 at phase 12's shapes: the prefill (8 x 512 from zero) and one
    decode step (8 x 1 from a state), each first held to its plain version
    on the timed inputs, then timed beside it, with its bound: the larger
    of its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s
    (no one PyTorch call computes the scan, so no library time)."""
    from repro_torch.kernels.mamba_scan import (
        mamba1_scan, mamba1_scan_reference)
    cases = card_cases("test_torch_mamba_scan_cuda")
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
        bound_ms, bound_by = _bound(nbytes, flops, FP32_FLOPS)
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
    cases = card_cases("test_torch_attention_cuda")
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


# -- phases 30 and 32: training -----------------------------------------------

TRAIN_ARCH = "qwen2-0.5b"


def _train_losses(out: str) -> dict:
    return {int(st): float(loss) for st, loss in re.findall(
        r"\[train\] step=(\d+) loss=(\S+) grad_norm=", out)}


def _train_launches(out: str) -> dict:
    m = re.search(r"kernel launches: flash_fwd=(\d+) flash_bwd=(\d+) "
                  r"scan_fwd=(\d+) scan_bwd=(\d+) flash_bwd_wgmma=(\d+)",
                  out)
    if not m:
        fail("launch.train printed no launch counts")
    return dict(zip(("flash_fwd", "flash_bwd", "scan_fwd", "scan_bwd",
                     "flash_bwd_wgmma"), map(int, m.groups())))


def train_cli() -> dict:
    """Phase 30, the training CLI: ``python -m repro_torch.launch.train --arch
    qwen2-0.5b --scale full --batch 8 --seq 512`` for 6 steps with a
    checkpoint every 3, then again to step 9 with ``--resume auto`` (run
    before this process touches the card).  Both exit 0; the second
    resumes from step 6 and reaches step 9; every logged loss is finite and
    step 9's is below step 1's; each process launched B3 forward and
    backward at least 24 times per step it ran, the backward on its
    tensor-core (``wgmma``) route."""
    import shutil
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ("--arch", TRAIN_ARCH, "--scale", "full", "--batch", "8",
            "--seq", "512", "--ckpt", str(ckpt), "--ckpt-every", "3",
            "--log-every", "1")
    runs = []
    try:
        for steps, extra in ((6, ()), (9, ("--resume", "auto"))):
            out, wall = run_module("repro_torch.launch.train", *base,
                                   "--steps", str(steps), *extra)
            runs.append((out, wall))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    (out1, wall1), (out2, wall2) = runs
    if "resumed from step 6" not in out2 or "step=9" not in out2:
        fail("the resumed training run did not continue from step 6 to 9")
    losses = {**_train_losses(out1), **_train_losses(out2)}
    if sorted(losses) != list(range(1, 10)):
        fail(f"training logged the steps {sorted(losses)}, want 1..9")
    if not all(math.isfinite(x) for x in losses.values()):
        fail(f"a training loss is not finite: {losses}")
    if not losses[9] < losses[1]:
        fail(f"the loss did not fall: step 1 {losses[1]}, step 9 "
             f"{losses[9]}")
    n = layer_calls(TRAIN_ARCH, "attn")
    for out, ran in ((out1, 6), (out2, 3)):
        got = _train_launches(out)
        for k in ("flash_fwd", "flash_bwd", "flash_bwd_wgmma"):
            if got[k] < n * ran:
                fail(f"launch.train launched {k} {got[k]} times in "
                     f"{ran} steps, want >= {n * ran}")
    log(f"phase 30 launch.train: {TRAIN_ARCH} full width bf16, 8 x 512 tokens: "
        f"losses {losses}; launches {_train_launches(out1)} (6 steps), "
        f"{_train_launches(out2)} (3 steps, resumed); {wall1:.1f} s and "
        f"{wall2:.1f} s wall")
    return {"losses": losses, "wall_s": (wall1, wall2)}


def train_in_process(dev, arch: str, wrappers: dict, *, batch: int = 8,
                     seq: int = 512, bwd_routes=None, **cut) -> dict:
    """Phase 30, in process: ``arch`` at full width in bf16 (depth cut by
    ``cut``), ``make_train_step`` as ``launch.train`` builds it (remat off, 2 CE
    chunks, its AdamW schedule); one warm-up step, then three steps timed
    by CUDA events (the median is the step time), tokens/s, the peak of
    allocated memory, and one more step under ``torch.profiler`` for the
    device's busy share.  ``wrappers`` maps a name to (wrapper, launches
    wanted per step): every count is set to 0 just before the timed steps
    and read just after; ``bwd_routes`` (route -> launches per step) is
    what B3's backward must have launched on each route, exactly.
    Returns the numbers and the counts."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    cfg = get_config(arch).scaled(**cut)
    t0 = time.perf_counter()
    model = M.Model(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    state = optim.init_opt_state(params)
    step = make_train_step(model, optim.AdamWConfig(warmup_steps=5,
                                                    decay_steps=10),
                           remat=False, ce_chunks=2)
    g = torch.Generator(dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, batch, seq + 1), generator=g,
                         device=dev, dtype=torch.int32)
    batches = [{"tokens": t[:, :-1], "targets": t[:, 1:]} for t in toks]
    state, m = step(state, batches[0])                  # warm-up
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    by_route = flash_attention_bwd.launches_by_route
    for w, _ in wrappers.values():
        w.launches = 0
    for r in by_route:
        by_route[r] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times, losses = [], []
    for b in batches[1:]:
        start.record()
        state, m = step(state, b)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    counts = {k: w.launches for k, (w, _) in wrappers.items()}
    routes = dict(by_route)
    peak = torch.cuda.max_memory_allocated(dev)
    for k, (_, per_step) in wrappers.items():
        if counts[k] < per_step * len(times):
            fail(f"{arch} training launched {k} {counts[k]} times in "
                 f"{len(times)} steps, want >= {per_step * len(times)}")
    if bwd_routes and routes != {r: bwd_routes.get(r, 0) * len(times)
                                 for r in routes}:
        fail(f"{arch} training launched B3's backward {routes} by route in "
             f"{len(times)} steps, want {bwd_routes} a step")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{arch} training losses are not finite: {losses}")
    wall_ms, dev_ms, n_kernels, top, _ = device_share(
        lambda: step(state, batches[1]))
    step_ms = statistics.median(times)
    share = f"{dev_ms / wall_ms:.3f}" if dev_ms else "not measured"
    log(f"phase 30 in process: {arch} {n_params} parameters ({cfg.dtype}"
        + (f", cut to {cut}" if cut else "") + f"), {batch} x {seq} tokens: "
        f"step {step_ms:.3f} ms (median of {times}), "
        f"{batch * seq / (step_ms / 1e3):.1f} tokens/s, peak allocated "
        f"{peak / 2**30:.2f} GiB, losses {losses}, launches {counts} over "
        f"{len(times)} steps (B3 backward by route {routes}); built and warmed in {build_s:.1f} s; profile "
        f"of one step: wall {wall_ms:.3f} ms (profiler on), device kernels "
        f"{dev_ms:.3f} ms in {n_kernels} launches, busy share {share}; top: "
        f"{top}")
    del model, params, state, step, batches, toks
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_s": batch * seq / (step_ms / 1e3),
            "peak_bytes": peak, "busy": share, "launches": counts}


def time_flash_bwd(dev, launches: int, B, S, H, KV, D, causal=True) -> dict:
    """Phase 32: B3's backward at one bf16 shape (the model's views, a
    grad_output laid out as the model's), held to its plain version on
    the timed inputs, then timed beside it, SDPA's backward (autograd
    through ``scaled_dot_product_attention(..., enable_gqa=True)`` on a
    retained graph, first checked to give the same gradients) and its
    bound: bytes (q, k, v, o, dO, lse read, dq, dk, dv written) over 3.35
    TB/s against 10 D operations per kept (query, key) pair (the five
    products Q K^T, dO V^T, P^T dO, dS K, dS^T Q) over 989 TFLOP/s.
    Fails unless every checked and timed call counted on
    ``bwd_route(bfloat16, D)`` and on no other route."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention_bhsd, flash_attention_bwd,
        flash_attention_bwd_reference)
    cases = card_cases("test_torch_train_cuda")
    which = bwd_route(torch.bfloat16, D)
    c = cases.attn_cases.model_flash(dev, torch.bfloat16, B=B, S=S, H=H,
                                     KV=KV, D=D)
    q, k, v = c["q"], c["k"], c["v"]
    g = torch.Generator(dev).manual_seed(2)
    do = torch.randn((B, S, H, D), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    o, lse = flash_attention_bhsd(q, k, v, causal=causal, with_lse=True)
    name = f"B3-bwd_bf16_b{B}_s{S}" + (
        "" if (H, KV, D) == (14, 2, 64) else f"_h{H}kv{KV}d{D}") + (
        "" if causal else "_bidir")

    def kernel():
        return flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

    def plain():
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    before = dict(flash_attention_bwd.launches_by_route)
    got, want = kernel(), plain()
    err = 0.0
    for gg, ww in zip(got, want):
        err = max(err, (gg.float() - ww.float()).abs().max().item())
        if not torch.allclose(gg.float(), ww.float(),
                              **cases.BWD_TOLS["bfloat16"]):
            fail(f"{name}: backward kernel disagrees with its plain version "
                 f"at the timed shape: max abs err {err:.3g}")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    for gg, ww in zip(sdpa_bwd(), want):
        ww = ww.float()
        if not torch.allclose(gg.float(), ww, rtol=2e-2, atol=8e-3 * max(
                1.0, ww.abs().max().item())):
            fail("SDPA's backward (yardstick) does not give B3's gradients")
    ms, plain_ms = _time_pair(kernel, plain)
    library_ms = cuda_ms(sdpa_bwd)
    nbytes = 2 * (4 * B * S * H * D + 4 * B * S * KV * D) + 4 * B * H * S
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 10 * D * H * B * pairs
    bound_ms, bound_by = _bound(nbytes, flops)
    dev_ms = _device_ms_per_call(kernel)
    moved = [r for r, n in flash_attention_bwd.launches_by_route.items()
             if n != before[r]]
    if moved != [which]:
        fail(f"{name}: the checked and timed calls ran on routes {moved}, "
             f"not on {which} alone")
    log(f"{name}: H={H} KV={KV} D={D} "
        f"{'causal' if causal else 'bidirectional'}, {which} route: max abs "
        f"err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"backward "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {nbytes} "
        f"B, {flops} flop), achieved {flops / (ms * 1e-3) / 1e12:.2f} "
        f"TFLOP/s; device time per call (profiler): kernel {dev_ms}, SDPA "
        f"backward {_device_ms_per_call(sdpa_bwd)}")
    source = ("flash_attention_bwd_wgmma.cu" if which == "wgmma"
              else "flash_attention_bwd.cu")
    return {"name": name, "route": "cuda", "kernel_route": which,
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def time_scan_bwd(dev, launches: int) -> dict:
    """Phase 32: B4's backward at falcon-mamba's training shape (8 x 512,
    8,192 channels, 16 states, no initial state, no h_last gradient), as
    training calls it: from the checkpoints its forward pass kept (the
    forward with checkpoints is timed beside it, for the log).  Held to
    its plain version, then timed beside it with its bound: bytes (x, dt,
    dy, B_t, C_t, A read; dx, ddt, dB, dC, dA written; not the
    checkpoints, which the function does not need) over 3.35 TB/s
    against 20 float32 operations per (b, t, d, n) (the states
    recomputed, then the recurrence above) over 67 TFLOP/s; no one
    PyTorch call computes it, so no library time."""
    import torch

    from repro_torch.kernels.mamba_scan import (
        mamba1_scan, mamba1_scan_bwd, mamba1_scan_bwd_reference)
    cases = card_cases("test_torch_train_cuda")
    c = cases.scan_bwd_case(cases.scan_cases.falcon_case(dev, 512,
                                                         with_h0=False), dev)
    args = [c[n] for n in ("x", "dt", "Bt", "Ct", "A")]
    B, T, Di = c["x"].shape
    N = c["A"].shape[1]
    name = f"B4-bwd_f32_b{B}_t{T}"

    _, _, ckpt = mamba1_scan(*args, with_checkpoints=True)

    def kernel():
        return mamba1_scan_bwd(*args, None, c["dy"], None, ckpt)

    def plain():
        return mamba1_scan_bwd_reference(*args, None, c["dy"], None)
    err = 0.0
    for gg, ww in zip(kernel()[:5], plain()[:5]):
        try:
            err = max(err, cases.scan_check(gg, ww))
        except AssertionError as e:
            fail(f"{name}: backward kernel disagrees with its plain version "
                 f"at the timed shape: {e}")
    ms, plain_ms = _time_pair(kernel, plain)
    nbytes = 4 * (5 * B * T * Di + 4 * B * T * N + 2 * Di * N)
    flops = 20 * B * T * Di * N
    bound_ms, bound_by = _bound(nbytes, flops, FP32_FLOPS)
    dev_ms = _device_ms_per_call(kernel)
    fwd_ms = cuda_ms(lambda: mamba1_scan(*args, with_checkpoints=True))
    log(f"{name}: Di={Di} N={N}: max abs err {err:.3g}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{nbytes} B, {flops} flop), achieved "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; device time per call "
        f"(profiler): kernel {dev_ms}; the forward with checkpoints "
        f"{fwd_ms:.4f} ms")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/mamba_scan_bwd.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:48",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def training(dev) -> list:
    """Phases 30 and 32 after the training CLI's runs: training in process
    at full width (qwen2-0.5b, then falcon-mamba-7b cut to 8 of its 64
    layers: with AdamW's float32 master, m and v the full depth needs
    about 116 GB), and the backward kernels' times.  Returns the kernel
    entries."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd, flash_attention_bwd)
    from repro_torch.kernels.mamba_scan import mamba1_scan, mamba1_scan_bwd
    t0 = time.perf_counter()
    n = layer_calls(TRAIN_ARCH, "attn")
    qwen = train_in_process(dev, TRAIN_ARCH, {
        "flash_fwd": (flash_attention_bhsd, n),
        "flash_bwd": (flash_attention_bwd, n)}, bwd_routes={"wgmma": n})
    falcon = train_in_process(dev, "falcon-mamba-7b", {
        "scan_fwd": (mamba1_scan, 8), "scan_bwd": (mamba1_scan_bwd, 8)},
        n_layers=8)
    t1 = time.perf_counter()
    entries = [time_flash_bwd(dev, qwen["launches"]["flash_bwd"], 8, 512, 14,
                              2, 64),
               time_flash_bwd(dev, qwen["launches"]["flash_bwd"], 8, 1500, 12,
                              12, 64, causal=False),
               time_scan_bwd(dev, falcon["launches"]["scan_bwd"])]
    log(f"phase 30 in process took {t1 - t0:.1f} s, phase 32 "
        f"{time.perf_counter() - t1:.1f} s")
    return entries


# -- phases 34-36: the dry-run, the placed model path, one rank's shapes -----

DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k", ()),
                ("qwen2-0.5b", "train_4k", ()),
                ("granite-moe-3b-a800m", "prefill_32k", ()),
                ("falcon-mamba-7b", "prefill_32k", ()),
                ("qwen2-0.5b", "decode_32k", ("--multi-pod",)))
DRYRUN_TIMEOUT_S = 300


def dryrun_cells() -> list:
    """Phase 34: the dry-run CLI for each of ``DRYRUN_CELLS``, all at once
    as subprocesses of their own sessions (killed at the time limit);
    returns the records."""
    out_dir = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for arch, cell, extra in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--cell", cell, "--out", str(out_dir), *extra]
        procs.append((arch, cell, extra, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT, start_new_session=True)))
    t0 = time.perf_counter()
    recs = []
    for arch, cell, extra, proc in procs:
        try:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        mesh = "multipod_2x16x16" if extra else "pod_16x16"
        ok = [line for line in out.splitlines()
              if f"{arch} x {cell}: OK" in line]
        if proc.returncode != 0 or not ok:
            for line in out.splitlines()[-30:]:
                log(f"  {line}")
            fail(f"dryrun {arch} {cell} {' '.join(extra)} exited "
                 f"{proc.returncode}")
        log(ok[0])
        rec = json.loads((out_dir / f"{mesh}__{arch}__{cell}.json"
                          ).read_text())
        mem, colls, terms = rec["memory"], rec["collectives"], rec["roofline"]
        if rec["status"] != "ok" or not (
                rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
                and colls["total_count"] > 0
                and mem["argument_size_in_bytes"] > 0):
            fail(f"dryrun record {mesh} {arch} {cell} is not whole: {rec}")
        log(f"  {mesh} {arch} {cell}: {rec['n_devices']} ranks, flops/dev "
            f"{rec['flops_per_device']:.4e}, bytes/dev "
            f"{rec['bytes_per_device']:.4e}, collectives "
            f"{colls['total_bytes']:.4e} B in {colls['total_count']} ops "
            f"({ {k: v for k, v in colls.items() if k.endswith('_count')} }), "
            f"memory: arguments {mem['argument_size_in_bytes']} B, temp "
            f"{mem['temp_size_in_bytes']} B, peak "
            f"{mem['peak_size_in_bytes']} B; H100 terms: compute "
            f"{terms['compute_s']:.4e} s, memory (traced) "
            f"{terms['memory_s']:.4e} s, memory (analytic) "
            f"{terms['memory_s_h100_est']:.4e} s, collective "
            f"{terms['collective_s']:.4e} s, dominant "
            f"{terms['dominant_h100']}, roofline fraction "
            f"{terms['roofline_fraction_h100']:.4f}; "
            f"extrapolated {rec['extrapolated'] is not None}; trace "
            f"{rec['compile_s']} s, done at {wall:.1f} s")
        recs.append(rec)
    return recs


def mesh_path(dev) -> dict:
    """Phase 35: qwen2-0.5b as published (bf16), prefill 8 x 512 and 8
    decode steps, with no mesh and then with its parameters placed on a
    (1, 1) mesh of a world-size-1 NCCL group, the same weights (seed 0);
    tokens, prefill logits and launches must be equal.  Returns the placed
    run's launches of B3 and B2 (each count set to 0 just before that run,
    read just after)."""
    import contextlib
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import is_dtensor, tree_map, use_mesh
    from repro_torch.kernels.decode_attention import decode_attention_bhd
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M

    cfg = get_config("qwen2-0.5b")
    B, S, N = 8, 512, 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    full = lambda t: t.full_tensor() if is_dtensor(t) else t  # noqa: E731

    def run(mesh):
        model = M.Model(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
        with (use_mesh(mesh) if mesh is not None
              else contextlib.nullcontext()):
            if mesh is not None:
                M.place_params(model)
                if not all(is_dtensor(p) for p in model.parameters()):
                    fail("place_params left a parameter unplaced")
            model.prefill(toks[:, :64])                    # warm-up
            torch.cuda.synchronize()
            flash_attention_bhsd.launches = decode_attention_bhd.launches = 0
            t0 = time.perf_counter()
            logits, cache = model.prefill(toks)
            logits = full(logits)
            cache = M.grow_cache(tree_map(full, cache), cfg, B, S + N)
            if mesh is not None:
                cache = M.place_tree(cache, M.cache_shardings(
                    cfg, M.cache_specs(cfg, B, S + N)))
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1).to(
                torch.int32)[:, None]
            out = [tok]
            for i in range(N):
                step, cache = model.decode_step(tok, cache, S + i)
                tok = full(step)[:, 0, :cfg.vocab_size].argmax(-1).to(
                    torch.int32)[:, None]
                out.append(tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"flash": flash_attention_bhsd.launches,
                    "decode": decode_attention_bhd.launches}
        del model, cache
        torch.cuda.empty_cache()
        return torch.cat(out, 1), logits, launches, wall

    plain = run(None)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        placed = run(make_debug_mesh((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()
    same_tokens = torch.equal(plain[0], placed[0])
    same_logits = torch.equal(plain[1], placed[1])
    log(f"qwen2-0.5b placed on a (1, 1) NCCL mesh: tokens equal "
        f"{same_tokens}, prefill logits equal {same_logits} (max abs diff "
        f"{(plain[1].float() - placed[1].float()).abs().max().item():.3g}), "
        f"launches {placed[2]} (no mesh {plain[2]}); wall of the prefill "
        f"and {N} steps {placed[3]:.3f} s (no mesh {plain[3]:.3f} s)")
    want = {"flash": 24, "decode": 24 * N}
    if not (same_tokens and placed[2] == plain[2] == want):
        fail(f"the placed model path differs from the unplaced one: tokens "
             f"{same_tokens}, launches {placed[2]} vs {plain[2]} (want "
             f"{want})")
    return placed[2]


def local_kernels(dev, mesh_launches: dict, scan_launches: int) -> list:
    """Phase 36: B3 and B2 at qwen2-0.5b's and B4 at falcon-mamba-7b's
    shapes on one rank of pod_16x16 (module docstring)."""
    import torch

    from repro_torch.configs import CELLS_BY_NAME, get_config
    from repro_torch.kernels.mamba_scan import (
        mamba1_scan, mamba1_scan_reference)
    from repro_torch.models.attention import head_layout
    tp = dp = 16
    qwen = get_config("qwen2-0.5b")
    lay = head_layout(qwen.n_heads, qwen.n_kv_heads, qwen.head_dim, tp)
    pre, dec = CELLS_BY_NAME["prefill_32k"], CELLS_BY_NAME["decode_32k"]
    # prefill: each rank its hp/tp query heads and the g/tp kv groups
    # expanded for them; decode: the cache on its slots (kv heads 2 do not
    # divide tp), every query head over the rank's slots
    log(f"qwen2-0.5b at tp {tp}: {lay}")
    out = [time_flash(dev, mesh_launches, pre.global_batch // dp,
                      pre.seq_len, lay.hp // tp, lay.g // tp, lay.d_head,
                      plain=flash_plain_chunked),
           time_decode(dev, mesh_launches, dec.global_batch // dp,
                       dec.seq_len // tp, H=lay.hp, KV=lay.kv_store,
                       D=lay.d_head, with_lse=True)]

    falcon = get_config("falcon-mamba-7b")
    B, T = pre.global_batch // dp, pre.seq_len
    Di, N = falcon.ssm.expand * falcon.d_model // tp, falcon.ssm.d_state
    g = torch.Generator(dev).manual_seed(36)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)
    c = dict(x=normal(B, T, Di),
             dt=torch.nn.functional.softplus(normal(B, T, Di)),
             Bt=normal(B, T, N), Ct=normal(B, T, N),
             A=-torch.exp(0.3 * normal(Di, N)))
    run = lambda fn, t=T: fn(c["x"][:, :t], c["dt"][:, :t],  # noqa: E731
                             c["Bt"][:, :t], c["Ct"][:, :t], c["A"])
    name = f"mamba_scan_f32_b{B}_t{T}_di{Di}"
    cut = 2048
    err = _scan_err(run(mamba1_scan, cut), run(mamba1_scan_reference, cut),
                    f"{name} (first {cut} steps)")
    ms = cuda_ms(lambda: run(mamba1_scan))
    plain_ms = cuda_ms(lambda: run(mamba1_scan_reference), iters=1,
                       warmup=1)
    nbytes = 4 * (3 * B * T * Di + 2 * B * T * N + Di * N + B * Di * N)
    flops = 7 * B * T * Di * N + B * T * Di
    bound_ms, bound_by = _bound(nbytes, flops, FP32_FLOPS)
    dev_ms = _device_ms_per_call(lambda: run(mamba1_scan), calls=5)
    log(f"{name}: max abs err {err:.3g} over the first {cut} steps, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms (one call), bound "
        f"{bound_ms:.4f} ms ({bound_by}; {nbytes} B, {flops} flop), achieved "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; device time per call "
        f"(profiler): kernel {dev_ms}")
    out.append({"name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/mamba_scan.cu",
                "replaces": "src/repro/kernels/mamba_scan.py:48",
                "launches": scan_launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
    return out


# -- phase 37: the experts' dispatch and combine -------------------------------

# (arch, tokens): one moe layer at the decode steps of the gen-decode (64
# rows) and gen-prefill (8 rows) cells, granite-moe's widths, and at
# qwen2-moe-a2.7b's over 64
MOE_SHAPES = (("granite-moe-3b-a800m", 64), ("granite-moe-3b-a800m", 8),
              ("qwen2-moe-a2.7b", 64))
# the whole layer, plain path against fused, up to MAX_ASSIGNMENTS at
# top-8 (granite) and top-4 (qwen2-moe)
MOE_LAYER_TOKENS = {"granite-moe-3b-a800m": (8, 64, 128, 256),
                    "qwen2-moe-a2.7b": (64, 128, 256, 512)}


def _replayed_ms(fn, reps: int = 300) -> float:
    """``fn`` captured in a CUDA graph (after three warm-up calls on a
    side stream), ms a replay: the least of three rounds of ``reps``
    replays between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = math.inf
    for _ in range(3):
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _kernel_name(key: str) -> str:
    """A profiler's kernel key without its namespace, template and
    arguments."""
    m = re.search(r"(\w+_kernel)\b", key)
    return m.group(1) if m else key


def _moe_held_to_plain(layer, x, path_fn, what: str) -> float:
    """A kernel path's moe layer (``path_fn``, ``moe._moe_fused`` or
    ``_moe_routed``) held to the plain one (``_moe_gather``) at the timed
    inputs, to two bf16 steps (``tests/test_torch_moe_cuda.py``'s limit);
    returns the max abs error."""
    import torch

    from repro_torch.models import moe as TMoE
    tol = card_cases("test_torch_moe_cuda").BF16_TOL
    params = {k: v.detach() for k, v in layer.named_parameters()}
    y, y_plain = (fn(params, x, layer.dims)[0].float()
                  for fn in (path_fn, TMoE._moe_gather))
    err = (y - y_plain).abs().max().item()
    if not torch.allclose(y, y_plain, rtol=tol,
                          atol=2 * tol * y_plain.abs().max().item()):
        fail(f"{what}: the kernel layer disagrees with the plain one at the "
             f"timed inputs: max abs err {err:.3g}")
    return err


def _moe_kernel_entries(layer, x, tag: str, dispatch, combine, source: str,
                        launches: dict, err: float, layer_ms: dict,
                        how: str) -> list:
    """The ``kernels`` entries of one kernel path's dispatch and combine
    over ``x``: each timed beside its plain counterpart (``_route`` and
    ``_bucket``, router product included, for the dispatch; ``_combine``
    for the combine), its device time by kernel and its bound (bytes over
    3.35 TB/s); ``err`` and ``layer_ms`` (the whole layer's times, ``how``
    measured) ride along."""
    import torch

    from repro_torch.models import moe as TMoE
    dims = layer.dims
    n = x.shape[0]
    E, k, d = dims.e_pad, dims.top_k, dims.d_model
    C = TMoE._capacity(n, dims)
    logits = x.float() @ layer.router
    xe, ge, slots, _ = dispatch(logits, x, dims.n_experts, k, C)
    y_e = TMoE._expert_ffn(layer.w_gate, layer.w_up, layer.w_down, xe)
    del xe
    gates, idx, _ = TMoE._route(layer.router, x, dims)
    _, _, tok = TMoE._bucket(x, gates, idx, C, dims)
    del gates, idx
    kept = int((slots >= 0).sum())
    calls = {
        # logits and x read; xe, ge, slots and aux written
        dispatch.__name__: (
            lambda: dispatch(logits, x, dims.n_experts, k, C),
            lambda: TMoE._bucket(x, *TMoE._route(layer.router, x, dims)[:2],
                                 C, dims),
            4 * n * E + 2 * n * d + 2 * E * C * d + 4 * E * C + 4 * n * k
            + 4),
        # the kept slots' rows and gates and the slot lists read; the
        # tokens' rows written
        combine.__name__: (
            lambda: combine(y_e, ge, slots),
            lambda: TMoE._combine(y_e, ge, tok, n, d, k),
            kept * (2 * d + 4) + 4 * n * k + 2 * n * d),
    }
    out = []
    for kname, (kernel, plain, nbytes) in calls.items():
        ms, plain_ms = _time_pair(kernel, plain)
        by_kernel = _device_ms_by_kernel(kernel, calls=5)
        dev_ms = sum(by_kernel.values()) if by_kernel else None
        bound_ms = _bound(nbytes, 0)[0]
        name = f"{kname}_bf16_{tag}_n{n}"
        log(f"{name}: E_pad {E}, top-{k}, d {d}, C {C}, {kept} kept "
            f"assignments: the kernel layer's max abs err {err:.3g}, kernel "
            f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms "
            f"(bytes; {nbytes} B), {100 * bound_ms / ms:.1f}% of it; device "
            f"time per call (profiler): "
            + (f"{dev_ms:.5f} ms: " + ", ".join(
                f"{_kernel_name(key)} {v:.5f}"
                for key, v in sorted(by_kernel.items()))
               if by_kernel else "not measured")
            + f"; the layer ({how}): " + ", ".join(
                f"{path} {v:.5f} ms" for path, v in layer_ms.items()))
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "src/repro/models/moe.py (_route, _bucket, "
                        "_combine: XLA, no kernel)",
            "launches": launches[kname], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None, "dev_ms": dev_ms,
            "layer_ms": layer_ms})
    return out


def moe_kernels(dev, launches: dict) -> list:
    """Phase 37, the decode-sized kernels (module docstring).
    ``launches`` maps each arch to its model path's launch counts (phases
    21-22)."""
    import torch

    from repro_torch.kernels.moe_dispatch import (
        MAX_ASSIGNMENTS, moe_combine, moe_dispatch)
    from repro_torch.models import moe as TMoE
    moe_cases = card_cases("test_torch_moe_cuda")

    layers, layer_ms, slower = {}, {}, []
    with torch.no_grad():
        for arch, tokens in MOE_LAYER_TOKENS.items():
            layer = layers[arch] = moe_cases.experts(arch, dev,
                                                     torch.bfloat16)
            dims = layer.dims
            params = {k: v.detach() for k, v in layer.named_parameters()}
            for n in tokens:
                if n * dims.top_k > MAX_ASSIGNMENTS:
                    continue
                x = torch.randn((n, dims.d_model), device=dev,
                                generator=torch.Generator(dev).manual_seed(
                                    1)).to(torch.bfloat16)
                ms = {path: _replayed_ms(lambda: fn(params, x, dims))
                      for path, fn in (("plain", TMoE._moe_gather),
                                       ("fused", TMoE._moe_fused))}
                layer_ms[arch, n] = ms
                log(f"moe layer {arch} bf16 over {n} tokens ({n * dims.top_k}"
                    f" assignments, C {TMoE._capacity(n, dims)}), a replayed "
                    f"graph: plain {ms['plain']:.5f} ms, fused "
                    f"{ms['fused']:.5f} ms ({ms['plain'] / ms['fused']:.2f}x)")
                if ms["fused"] >= ms["plain"]:
                    slower.append((arch, n))
    if slower:
        fail(f"the fused moe layer is not faster than the plain one at "
             f"{slower}, within MAX_ASSIGNMENTS {MAX_ASSIGNMENTS}")

    out = []
    for arch, n in MOE_SHAPES:
        layer = layers[arch]
        x = torch.randn((n, layer.dims.d_model), device=dev,
                        generator=torch.Generator(dev).manual_seed(1)).to(
                            torch.bfloat16)
        with torch.no_grad():
            err = _moe_held_to_plain(layer, x, TMoE._moe_fused,
                                     f"moe {arch} over {n} tokens")
            out += _moe_kernel_entries(
                layer, x, arch.split("-moe")[0], moe_dispatch, moe_combine,
                "src/repro_torch/csrc/moe_dispatch.cu", launches[arch], err,
                layer_ms[arch, n], "a replayed graph")
    del layers
    torch.cuda.empty_cache()
    return out


# (arch, tokens): one moe layer at the prefills of gen-hybrid-16k (4 x
# 16,384), gen-prefill (8 x 4,080) and gen-decode (64 x 256), and at
# gen-hybrid-16k's decode step (4 rows), which the routed kernels take
ROUTED_SHAPES = (("granite-4.0-h-small", 65536), ("granite-4.0-h-small", 4),
                 ("granite-moe-3b-a800m", 32640),
                 ("granite-moe-3b-a800m", 16384))
ROUTED_DECODE_TOKENS = 64   # up to it a layer is timed as a replayed graph


def routed_kernels(dev, launches: dict) -> list:
    """Phase 37, the routed kernels (module docstring).  ``launches`` maps
    each arch to its model path's launch counts (phases 21 and 38)."""
    import torch

    from repro_torch.kernels.moe_routed import (
        moe_routed_combine, moe_routed_dispatch)
    from repro_torch.models import moe as TMoE
    moe_cases = card_cases("test_torch_moe_cuda")

    out, slower = [], []
    for arch, n in ROUTED_SHAPES:
        layer = moe_cases.experts(arch, dev, torch.bfloat16)
        dims = layer.dims
        params = {key: v.detach() for key, v in layer.named_parameters()}
        x = torch.randn((n, dims.d_model), device=dev,
                        generator=torch.Generator(dev).manual_seed(1)).to(
                            torch.bfloat16)
        paths = (("plain", TMoE._moe_gather), ("routed", TMoE._moe_routed))
        with torch.no_grad():
            err = _moe_held_to_plain(layer, x, TMoE._moe_routed,
                                     f"moe {arch} over {n} tokens")
            if n <= ROUTED_DECODE_TOKENS:
                how = "a replayed graph"
                layer_ms = {path: _replayed_ms(lambda: fn(params, x, dims))
                            for path, fn in paths}
            else:
                how = "eager, CUDA events, best of two rounds of five"
                layer_ms = {path: min(cuda_ms(lambda: fn(params, x, dims),
                                              iters=5, warmup=2)
                                      for _ in range(2))
                            for path, fn in paths}
            if layer_ms["routed"] >= layer_ms["plain"]:
                slower.append((arch, n))
            tag = "".join(w[0] if i else w for i, w in enumerate(
                arch.split("-")[:2]))
            out += _moe_kernel_entries(
                layer, x, tag, moe_routed_dispatch, moe_routed_combine,
                "src/repro_torch/csrc/moe_routed.cu", launches[arch], err,
                layer_ms, how)
        del layer, params, x
        torch.cuda.empty_cache()
    if slower:
        fail(f"the routed moe layer is not faster than the plain one at "
             f"{slower}")
    return out


# -- phase 39: the card tests -------------------------------------------------

def card_tests() -> None:
    """Phase 39: every ``tests/test_torch_*_cuda.py`` under ``pytest -m
    cuda`` in a subprocess (``--noconftest``: ``tests/conftest.py`` imports
    jax); a failed test or a collection error exits non-zero and fails the
    run, and so does a run in which none passed."""
    files = sorted(str(f.relative_to(ROOT))
                   for f in (ROOT / "tests").glob("test_torch_*_cuda.py"))
    out, wall = run_module("pytest", "-q", "--noconftest", "-p",
                           "no:cacheprovider", "-m", "cuda", *files,
                           timeout=CARD_TESTS_TIMEOUT_S)
    counts = {word: int(n) for n, word in
              re.findall(r"(\d+) (\w+)", out.strip().splitlines()[-1])}
    log(f"card tests ({len(files)} files): {counts.get('passed', 0)} passed, "
        f"{counts.get('failed', 0)} failed, {counts.get('skipped', 0)} "
        f"skipped in {wall:.1f} s")
    if not counts.get("passed"):
        fail("no card test passed")


# -- phase 38: granite-4.0-h's first pipeline stage --------------------------

HYBRID_ARCH = "granite-4.0-h-small"
HYBRID_LAYERS = 20                  # the first of two pipeline stages
HYBRID_SHAPE = (4, 16384, 64)       # gen-hybrid-16k: rows, prompt, tokens


def hybrid_path(dev) -> list:
    """Phase 38: granite-4.0-h-small's first pipeline stage (layers 0-19:
    18 Mamba-2 and 2 NoPE attention layers, each with 72 experts top-10 and
    the shared expert) in bf16 at every published width, the weights
    ``Model``'s own draw, at portbench's gen-hybrid-16k shapes:
    ``Model.prefill`` over 4 x 16,384 tokens, then 64 greedy tokens by the
    captured ``decode_multi`` and by the stepwise ``decode_step`` loop
    from the same cache, which must give the same tokens and caches bit
    for bit.  Every launch count is set to 0 just before the prefill and
    read after each part: B3 2 launches in the prefill, all on its
    ``wgmma`` route, B2 none; B2 2 a step over the replayed steps, B3
    none; the decode-sized moe kernels none (72 experts and top-10 lie
    outside ``moe_dispatch.takes``), the routed ones in every layer (3 + 1
    launches a layer, in the prefill and in each replayed step), and
    ``moe.PATH_CALLS`` "routed" alone rising, by 20 in the prefill and by
    a multiple of 20 in ``decode_multi``'s capture; the SSD kernel 18
    launches in the prefill, none in decode; Mamba-2 18 mixer calls, 18 x
    64 SSD chunks and 18 SSDs on the kernel in the prefill.
    Then, the model freed, B3 at the prefill's shape (held to the chunked
    plain version) and B2 at the last step's (4 rows over 16,448 slots),
    GQA 32/8 at D 128, held to their plain versions and timed as phase 10
    times them, and the SSD kernel at one layer (``time_ssd``).  Returns
    their ``kernels`` entries and the run's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_bhd
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
    from repro_torch.kernels.moe_routed import (
        moe_routed_combine, moe_routed_dispatch)
    from repro_torch.kernels.ssd import ssd_chunk
    from repro_torch.models import model as M
    from repro_torch.models.moe import PATH_CALLS
    from repro_torch.models.ssm import MAMBA2_COUNTS
    graph_cases = card_cases("test_torch_graph_cuda")

    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS,
                              layer_types=full.layer_types[:HYBRID_LAYERS])
    n_attn = cfg.layer_types.count("attention")
    n_ssm = HYBRID_LAYERS - n_attn
    B, S, N = HYBRID_SHAPE
    t0 = time.perf_counter()
    model = M.Model(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(38).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    # warm-up at the timed shapes, not counted
    _, c = model.prefill(toks)
    c = M.grow_cache(c, cfg, B, S + N)
    model.decode_step(toks[:, :1], c, S)
    del c
    torch.cuda.synchronize()
    log(f"model: {cfg.name} cut to {HYBRID_LAYERS} layers, {n_params} "
        f"parameters ({cfg.dtype}), built and warmed in "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = {"flash": flash_attention_bhsd, "decode": decode_attention_bhd,
               "moe_dispatch": moe_dispatch, "moe_combine": moe_combine,
               "moe_routed_dispatch": moe_routed_dispatch,
               "moe_routed_combine": moe_routed_combine, "ssd": ssd_chunk}
    for w in kernels.values():
        w.launches = 0
    by_route = flash_attention_bhsd.launches_by_route
    for r in by_route:
        by_route[r] = 0
    counts0, paths0 = dict(MAMBA2_COUNTS), dict(PATH_CALLS)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    logits, cache = model.prefill(toks)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev)
    in_prefill = {k: w.launches for k, w in kernels.items()}
    prefill_paths = {k: v - paths0[k] for k, v in PATH_CALLS.items()}
    if prefill_paths != {"fused": 0, "gather": 0, "routed": HYBRID_LAYERS}:
        fail(f"{HYBRID_ARCH}: the prefill's moe layers took the paths "
             f"{prefill_paths}, want routed {HYBRID_LAYERS} of "
             f"{HYBRID_LAYERS}")
    want = {"flash": n_attn, "decode": 0, "moe_dispatch": 0,
            "moe_combine": 0, "moe_routed_dispatch": 3 * HYBRID_LAYERS,
            "moe_routed_combine": HYBRID_LAYERS, "ssd": n_ssm}
    if in_prefill != want or dict(by_route) != {**dict.fromkeys(by_route, 0),
                                                "wgmma": n_attn}:
        fail(f"{HYBRID_ARCH}: the prefill launched {in_prefill} (routes "
             f"{dict(by_route)}), want {want}, all of B3's on wgmma")
    ssm_calls, ssm_chunks, ssm_kernel = (
        MAMBA2_COUNTS[k] - counts0[k] for k in ("calls", "chunks",
                                                "kernel_calls"))
    chunks_each = -(-S // cfg.ssm.chunk)
    if (ssm_calls, ssm_chunks, ssm_kernel) != (n_ssm, n_ssm * chunks_each,
                                               n_ssm):
        fail(f"{HYBRID_ARCH}: the prefill ran {ssm_calls} Mamba-2 mixers, "
             f"{ssm_chunks} SSD chunks and {ssm_kernel} SSDs on the kernel, "
             f"want {n_ssm}, {n_ssm * chunks_each} and {n_ssm}")
    if not torch.isfinite(logits).all():
        fail(f"{HYBRID_ARCH}: prefill logits are not finite")
    saved = M.grow_cache(cache, cfg, B, S + N)
    del cache
    first = logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    graph_c, eager_c = _clone(saved), _clone(saved)
    paths0 = dict(PATH_CALLS)
    captured, _, clen = model.decode_multi(first, graph_c, S, N)  # capture
    capture_paths = {k: v - paths0[k] for k, v in PATH_CALLS.items()}
    if capture_paths["fused"] or capture_paths["gather"] \
            or not capture_paths["routed"] \
            or capture_paths["routed"] % HYBRID_LAYERS:
        fail(f"{HYBRID_ARCH}: decode_multi's capture took the moe paths "
             f"{capture_paths}, want routed only, {HYBRID_LAYERS} a step")
    graph_cases.restore(graph_c, saved)
    before = {k: w.launches for k, w in kernels.items()}
    torch.cuda.synchronize()
    start.record()
    fused, _, clen = model.decode_multi(first, graph_c, S, N)
    end.record()
    torch.cuda.synchronize()
    graph_ms = start.elapsed_time(end) / N
    replayed = {k: w.launches - before[k] for k, w in kernels.items()}
    start.record()
    steps = graph_cases.stepwise(model, first, eager_c, S, N)
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / N
    want = {"flash": 0, "decode": n_attn * N, "moe_dispatch": 0,
            "moe_combine": 0, "moe_routed_dispatch": 3 * HYBRID_LAYERS * N,
            "moe_routed_combine": HYBRID_LAYERS * N, "ssd": 0}
    if replayed != want:
        fail(f"{HYBRID_ARCH}: {N} replayed steps launched {replayed}, want "
             f"{want}")
    if not (torch.equal(captured, steps) and torch.equal(fused, steps)) \
            or int(clen) != S + N:
        fail(f"{HYBRID_ARCH}: decode_multi differs from stepwise decoding: "
             f"{fused.tolist()} vs {steps.tolist()}")
    differ = graph_cases.unequal_leaves(graph_c, eager_c)
    if differ:
        fail(f"{HYBRID_ARCH}: the captured decode_multi's cache differs from "
             f"the eager loop's in {differ}")
    launches = {k: w.launches for k, w in kernels.items()}
    log(f"model path {HYBRID_ARCH} ({HYBRID_LAYERS} layers: {n_ssm} Mamba-2, "
        f"{n_attn} attention): prefill {B} x {S} tokens {prefill_ms:.3f} ms, "
        f"peak {peak} bytes allocated; decode {B} rows x {N} tokens: "
        f"decode_multi replayed {graph_ms:.3f} ms/token, stepwise "
        f"{eager_ms:.3f} ms/token; streams and caches equal; launches "
        + ", ".join(f"{k} {launches[k]} ({in_prefill[k]} in prefill, "
                    f"{replayed[k]} in a replayed call)" for k in kernels)
        + f"; Mamba-2 {ssm_calls} calls, {ssm_chunks} SSD chunks, "
        f"{ssm_kernel} of {ssm_calls} SSDs on the kernel in prefill; moe "
        f"PATH_CALLS routed {prefill_paths['routed']} of {HYBRID_LAYERS} "
        f"layers in the prefill, {capture_paths['routed']} in "
        f"decode_multi's capture of {N} steps (its warm-up and capture), "
        f"{capture_paths} in all")
    del model, logits, saved, graph_c, eager_c
    torch.cuda.empty_cache()
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    _chunked_is_plain(dev)
    return [time_flash(dev, launches, B, S, H, KV, D,
                       plain=flash_plain_chunked),
            time_decode(dev, launches, B, S + N, H=H, KV=KV, D=D),
            time_ssd(dev, launches["ssd"], cfg)], launches


def time_ssd(dev, launches: int, cfg) -> dict:
    """Phase 38: the SSD kernel at one layer of gen-hybrid-16k's prefill
    (the stage's Mamba-2 sizes over 4 x 16,384 positions, x, B and C in
    bf16 as slices of the conv's output), held to the plain path
    (``ssd_reference``) by the card test's rule (its error against a
    float64 evaluation no larger than ``AS_ACCURATE`` times the plain
    float32 path's, TF32 off), then timed beside it and two bounds:
    ``bound_ms``, this kernel's design, float32 FMAs on CUDA cores
    (operations over 67 TFLOP/s, or bytes over 3.35 TB/s); and
    ``tc_bound_ms``, the same work at float32's accuracy on the tensor
    cores by 3xTF32 (operations over a third of TF32's dense rate, or
    bytes)."""
    import torch

    from portbench.roofline_hybrid import ssd_flops
    from repro_torch.kernels.ssd import ssd_chunk
    from repro_torch.roofline.model import H100_SXM
    from repro_torch.models.ssm import ssd_reference, ssm_dims
    ssd_cases = card_cases("test_torch_ssd_cuda")

    dims = ssm_dims(cfg.ssm, cfg.d_model)
    B, S, _ = HYBRID_SHAPE
    nh, hd, n, G, T = (dims.n_heads, dims.head_dim, dims.d_state,
                       dims.groups, dims.chunk)
    inputs = ssd_cases.ssd_inputs(dev, B, S, nh, G, h0=False, seed=38)
    err = ssd_cases.relative_errors(inputs, T)
    limit = ssd_cases.AS_ACCURATE
    if err["kernel_y"] > limit * err["plain_y"] \
            or err["kernel_h"] > limit * err["plain_h"]:
        fail(f"ssd kernel less accurate than the plain path at the cell's "
             f"shape: {err}")

    def kernel():
        return ssd_chunk(**inputs, chunk=T)

    def plain():
        return ssd_reference(**inputs, chunk=T)
    ms = cuda_ms(kernel, iters=10)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    ms = min(ms, cuda_ms(kernel, iters=10))
    flops = ssd_flops({"chunk": T, "d_state": n, "n_groups": G,
                       "ssm_heads": nh, "ssm_head_dim": hd}, B, S)
    x_bytes = inputs["x"].element_size()
    nbytes = (B * S * (nh * hd * x_bytes + 2 * G * n * x_bytes + nh * 4)
              + B * S * nh * hd * 4 + B * nh * hd * n * 4)
    bound_ms, bound_by = _bound(nbytes, flops, FP32_FLOPS)
    # float32 products at float32's accuracy on the tensor cores: TF32
    # dense (half the bf16 peak) over the three products of a 3xTF32 split
    tf32x3 = H100_SXM.peak_flops / 2 / 3
    tc_bound_ms = _bound(nbytes, flops, tf32x3)[0]
    by_kernel = _device_ms_by_kernel(kernel, calls=5)
    dev_ms = sum(by_kernel.values()) if by_kernel else None
    name = f"ssd_chunk_bf16_b{B}_s{S}_h{nh}"
    log(f"{name}: hd {hd}, d_state {n}, {G} group, chunk {T}: error vs "
        f"float64 {err['kernel_y']:.3g} (plain float32 {err['plain_y']:.3g})"
        f", h_last {err['kernel_h']:.3g} ({err['plain_h']:.3g}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, CUDA-core float32 bound "
        f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} flop, {nbytes} B), "
        f"3xTF32 tensor-core bound {tc_bound_ms:.4f} ms, achieved "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; device time per call "
        f"(profiler): "
        + (f"{dev_ms:.4f} ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(by_kernel.items()))
           if by_kernel else "not measured"))
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk.cu",
            "replaces": None, "launches": launches,
            "max_rel_err": err["kernel_y"], "plain_rel_err": err["plain_y"],
            "ms": ms, "dev_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_of": "float32 FMAs on CUDA cores",
            "tc_bound_ms": tc_bound_ms, "tc_bound_of": "3xTF32 tensor cores",
            "library_ms": None}


# -- phase 40: DeepSeek-V2-Lite ------------------------------------------------

MLA_ARCH = "deepseek-v2-lite"
MLA_SHAPE = (4, 32768, 128)         # gen-mla-32k: rows, prompt, tokens


def mla_path(dev) -> list:
    """Phase 40: DeepSeek-V2-Lite whole (27 layers) in bf16 at every
    published width, the weights ``Model``'s own draw, at portbench's
    gen-mla-32k shapes: ``Model.prefill`` over 4 x 32,768 tokens, then
    128 greedy tokens by the captured ``decode_multi`` and by the stepwise
    ``decode_step`` loop from the same cache, which must give the same
    tokens and latent caches bit for bit.  Every launch count is set to 0
    just before the prefill and read after each part: B3 27 launches in
    the prefill, all ``wgmma``, none in decode; B2 none; the routed moe
    kernels 3 + 1 a layer of 26 in the prefill, none in decode; the
    decode-sized ones (4 rows x top-6, 24 assignments) none in the
    prefill, 1 + 1 a layer a replayed step; ``moe.PATH_CALLS`` and
    ``mla.MLA_COUNTS`` likewise.  Then, the model freed, B3 padded and the
    absorbed decode attention at the cell's shapes
    (``time_mla_kernels``).  Returns their ``kernels`` entries."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_bhd
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
    from repro_torch.kernels.moe_routed import (
        moe_routed_combine, moe_routed_dispatch)
    from repro_torch.models import model as M
    from repro_torch.models.mla import MLA_COUNTS
    from repro_torch.models.moe import PATH_CALLS
    graph_cases = card_cases("test_torch_graph_cuda")

    cfg = get_config(MLA_ARCH)
    L = cfg.n_layers
    n_moe = L - cfg.first_k_dense_replace
    B, S, N = MLA_SHAPE
    t0 = time.perf_counter()
    model = M.Model(cfg, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(40).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    _, c = model.prefill(toks)          # warm-up at the timed shapes
    c = M.grow_cache(c, cfg, B, S + N)
    model.decode_step(toks[:, :1], c, S)
    del c
    torch.cuda.synchronize()
    log(f"model: {cfg.name}, {n_params} parameters ({cfg.dtype}), built "
        f"and warmed in {time.perf_counter() - t0:.1f} s")

    kernels = {"flash": flash_attention_bhsd, "decode": decode_attention_bhd,
               "moe_dispatch": moe_dispatch, "moe_combine": moe_combine,
               "moe_routed_dispatch": moe_routed_dispatch,
               "moe_routed_combine": moe_routed_combine}
    for w in kernels.values():
        w.launches = 0
    by_route = flash_attention_bhsd.launches_by_route
    for r in by_route:
        by_route[r] = 0
    counts0, paths0 = dict(MLA_COUNTS), dict(PATH_CALLS)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    logits, cache = model.prefill(toks)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev)
    in_prefill = {k: w.launches for k, w in kernels.items()}
    prefill_paths = {k: v - paths0[k] for k, v in PATH_CALLS.items()}
    prefill_mla = {k: v - counts0[k] for k, v in MLA_COUNTS.items()}
    want = {"flash": L, "decode": 0, "moe_dispatch": 0, "moe_combine": 0,
            "moe_routed_dispatch": 3 * n_moe, "moe_routed_combine": n_moe}
    if in_prefill != want or dict(by_route) != {**dict.fromkeys(by_route, 0),
                                                "wgmma": L}:
        fail(f"{MLA_ARCH}: the prefill launched {in_prefill} (routes "
             f"{dict(by_route)}), want {want}, all of B3's on wgmma")
    if prefill_paths != {"fused": 0, "gather": 0, "routed": n_moe} \
            or prefill_mla != {"decompressed": L, "absorbed": 0,
                               "latent_slots": L * B * S, "padded_b3": L}:
        fail(f"{MLA_ARCH}: the prefill took the moe paths {prefill_paths} "
             f"and counted {prefill_mla}")
    if not torch.isfinite(logits).all():
        fail(f"{MLA_ARCH}: prefill logits are not finite")
    saved = M.grow_cache(cache, cfg, B, S + N)
    del cache
    first = logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    graph_c, eager_c = _clone(saved), _clone(saved)
    paths0, counts0 = dict(PATH_CALLS), dict(MLA_COUNTS)
    captured, _, clen = model.decode_multi(first, graph_c, S, N)  # capture
    capture_paths = {k: v - paths0[k] for k, v in PATH_CALLS.items()}
    absorbed = MLA_COUNTS["absorbed"] - counts0["absorbed"]
    if capture_paths["routed"] or capture_paths["gather"] \
            or not capture_paths["fused"] or capture_paths["fused"] % n_moe \
            or not absorbed or absorbed % L:
        fail(f"{MLA_ARCH}: decode_multi's capture took the moe paths "
             f"{capture_paths} and {absorbed} absorbed calls, want fused "
             f"only, {n_moe} and {L} a step")
    graph_cases.restore(graph_c, saved)
    before = {k: w.launches for k, w in kernels.items()}
    torch.cuda.synchronize()
    start.record()
    fused, _, clen = model.decode_multi(first, graph_c, S, N)
    end.record()
    torch.cuda.synchronize()
    graph_ms = start.elapsed_time(end) / N
    replayed = {k: w.launches - before[k] for k, w in kernels.items()}
    start.record()
    steps = graph_cases.stepwise(model, first, eager_c, S, N)
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / N
    want = {"flash": 0, "decode": 0, "moe_dispatch": n_moe * N,
            "moe_combine": n_moe * N, "moe_routed_dispatch": 0,
            "moe_routed_combine": 0}
    if replayed != want:
        fail(f"{MLA_ARCH}: {N} replayed steps launched {replayed}, want "
             f"{want}")
    if not (torch.equal(captured, steps) and torch.equal(fused, steps)) \
            or int(clen) != S + N:
        fail(f"{MLA_ARCH}: decode_multi differs from stepwise decoding: "
             f"{fused.tolist()} vs {steps.tolist()}")
    differ = graph_cases.unequal_leaves(graph_c, eager_c)
    if differ:
        fail(f"{MLA_ARCH}: the captured decode_multi's cache differs from "
             f"the eager loop's in {differ}")
    launches = {k: w.launches for k, w in kernels.items()}
    log(f"model path {MLA_ARCH} ({L} layers, {n_moe} with experts): prefill "
        f"{B} x {S} tokens {prefill_ms:.3f} ms, peak {peak} bytes "
        f"allocated; decode {B} rows x {N} tokens: decode_multi replayed "
        f"{graph_ms:.3f} ms/token, stepwise {eager_ms:.3f} ms/token; "
        f"streams and caches equal; launches "
        + ", ".join(f"{k} {launches[k]} ({in_prefill[k]} in prefill, "
                    f"{replayed[k]} in a replayed call)" for k in kernels)
        + f"; MLA_COUNTS in the prefill {prefill_mla}, absorbed calls in "
        f"decode_multi's capture {absorbed}; moe PATH_CALLS in the prefill "
        f"{prefill_paths}, in the capture {capture_paths}")
    del model, logits, saved, graph_c, eager_c
    torch.cuda.empty_cache()
    return time_mla_kernels(dev, cfg, launches)


def time_mla_kernels(dev, cfg, launches: dict) -> list:
    """Phase 40's kernels at gen-mla-32k's shapes, bf16.  B3 on the
    prefill's padded heads (4 x 32,768, 16 heads, q, k, v at 256): held to
    the chunked plain version of the same padded call, then timed beside
    it and two bounds, ``bound_ms`` on the work attention needs (pairs at
    192 and 128, q, k, v and o at their widths) and ``executed_bound_ms``
    on what the padded call does (256 and 256); and the whole
    ``decompressed_attention`` with its padding copies.  The absorbed
    decode attention (``mla.absorbed_attention``, plain products) of 4
    rows over the last step's 32,896 slots: held to a float32 evaluation
    of the decompressed attention from the same latent cache, timed by
    CUDA events and by the profiler's device time, beside its bound (the
    latent cache read once) and its executed bytes (``c_kv`` read twice,
    for the scores and for ``p c_kv``)."""
    import torch

    from repro_torch.kernels.flash_attention import (
        WGMMA_HEAD_DIMS, flash_attention_bhsd)
    from repro_torch.models import mla

    dims = mla.mla_dims(cfg)
    B, S, N = MLA_SHAPE
    H, Dn, Dr, Dv, R = dims.n_heads, dims.nope, dims.rope, dims.v, \
        dims.kv_rank
    P = min(p for p in WGMMA_HEAD_DIMS if p >= max(dims.qk, Dv))
    g = torch.Generator(dev).manual_seed(40)

    def r(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(
            torch.bfloat16)
    q_nope, q_pe, k_nope, v = (r(B, S, H, Dn), r(B, S, H, Dr),
                               r(B, S, H, Dn), r(B, S, H, Dv))
    k_pe = r(B, S, Dr)
    pre = dims.scale * P ** 0.5
    qp, kp, vp = (torch.zeros(B, S, H, P, dtype=torch.bfloat16, device=dev)
                  for _ in range(3))
    qp[..., :Dn], qp[..., Dn:dims.qk] = q_nope.float() * pre, \
        q_pe.float() * pre
    kp[..., :Dn], kp[..., Dn:dims.qk] = k_nope, k_pe[:, :, None]
    vp[..., :Dv] = v
    q4, k4, v4 = (t.transpose(1, 2) for t in (qp, kp, vp))

    def kernel():
        return flash_attention_bhsd(q4, k4, v4, causal=True)
    name = f"flash_attention_bf16_b{B}_s{S}_h{H}d{P}_mla_padded"
    err = _held_to_plain(kernel(), flash_plain_chunked(q4, k4, v4), name,
                         "flash")
    ms, plain_ms = _time_pair(kernel, lambda: flash_plain_chunked(q4, k4,
                                                                  v4))
    whole_ms = cuda_ms(lambda: mla.decompressed_attention(
        q_nope, q_pe, k_nope, k_pe, v, dims.scale), iters=5)
    pairs = B * H * S * (S + 1) // 2
    need_flops = 2 * pairs * (dims.qk + Dv)
    need_bytes = 2 * B * S * H * (2 * dims.qk + 2 * Dv)    # q, k, v, o
    done_flops = 4 * pairs * P
    done_bytes = 2 * B * S * H * 4 * P
    bound_ms, bound_by = _bound(need_bytes, need_flops)
    done_ms, done_by = _bound(done_bytes, done_flops)
    dev_ms = _device_ms_per_call(kernel, calls=5)
    log(f"{name}: wgmma route: max abs err {err:.3g}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, the whole padded call with its copies "
        f"{whole_ms:.4f} ms; bound on the needed work {bound_ms:.4f} ms "
        f"({bound_by}; {need_flops} flop at {dims.qk}/{Dv}, {need_bytes} "
        f"B), on the executed {done_ms:.4f} ms ({done_by}; {done_flops} "
        f"flop at {P}/{P}); achieved {need_flops / (ms * 1e-3) / 1e12:.2f} "
        f"TFLOP/s needed, {done_flops / (ms * 1e-3) / 1e12:.2f} executed; "
        f"device time per call (profiler): kernel {dev_ms}")
    out = [{"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "launches": launches["flash"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "whole_call_ms": whole_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "executed_bound_ms": done_ms, "executed_bound_by": done_by,
            "library_ms": None}]
    del q_nope, q_pe, k_nope, v, k_pe, qp, kp, vp, q4, k4, v4
    torch.cuda.empty_cache()

    Sc = S + N
    ckv = r(B, Sc, R)
    kpe = r(B, Sc, Dr)
    wkv_b = r(R, H, Dn + Dv, std=R ** -0.5)
    qn, qr = r(B, H, Dn), r(B, H, Dr)
    masked = torch.zeros(B, Sc, dtype=torch.bool, device=dev)

    def absorbed():
        return mla.absorbed_attention(qn, qr, ckv, kpe, wkv_b, masked,
                                      dims.scale)
    kv = (ckv.float() @ wkv_b.float().reshape(R, -1)).view(B, Sc, H, -1)
    s = (torch.einsum("bhn,bshn->bhs", qn.float(), kv[..., :Dn])
         + torch.einsum("bhr,bsr->bhs", qr.float(), kpe.float())) \
        * dims.scale
    want = torch.einsum("bhs,bshv->bhv", torch.softmax(s, -1), kv[..., Dn:])
    del kv, s
    name = f"mla_absorbed_decode_bf16_b{B}_sc{Sc}_h{H}"
    err = _held_to_plain(absorbed(), want, name, "flash")
    ms = cuda_ms(absorbed, iters=50)
    dev_ms = _device_ms_per_call(absorbed, calls=20)
    need_bytes = 2 * B * Sc * (R + Dr) + 2 * R * H * (Dn + Dv)
    done_bytes = need_bytes + 2 * B * Sc * R
    flops = 2 * B * H * (Sc * (2 * R + Dr) + R * (Dn + Dv))
    bound_ms, bound_by = _bound(need_bytes, flops)
    log(f"{name}: plain products (torch.bmm, float32 scores): max abs err "
        f"{err:.3g} against float32 decompressed attention, {ms:.4f} ms by "
        f"CUDA events, device time per call {dev_ms}; bound {bound_ms:.4f} "
        f"ms ({bound_by}; the latent cache and W_kv_b read once, "
        f"{need_bytes} B, {flops} flop), executed bytes {done_bytes} "
        f"({_bound(done_bytes, flops)[0]:.4f} ms)")
    out.append({"name": name, "route": "torch", "source":
                "src/repro_torch/models/mla.py", "replaces": None,
                "launches": None, "max_abs_err": err, "ms": ms,
                "dev_ms": dev_ms, "plain_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "executed_bytes": done_bytes,
                "library_ms": None})
    return out


if __name__ == "__main__":
    main()
