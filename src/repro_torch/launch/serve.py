"""Serving driver: the real multi-process engine under a request workload.

  PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \
      --arch qwen2-0.5b --tp 2 --requests 8

Runs the instrumented control plane (API-server tokenizer pool -> EngineCore
-> shm broadcast -> workers) on this machine, restricted to ``--cores``
logical CPUs (the paper's salloc-style budget), and reports TTFT /
tokenize / dequeue statistics.  With ``--backend torch`` every worker runs
the paged surrogate on the card (``--device cuda``, the default) through
the paged decode attention kernel, and it prints the kernel's
launches summed over the workers.

Ported from ``src/repro/launch/serve.py``: imports rewritten to
``repro_torch``; ``--backend torch`` with ``--device`` and ``--arch`` in
place of ``jax``.  The cpu and hybrid backends, speculative decode and
fleet mode (``--replicas > 1``) are not ported yet and exit with an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics as st
import time
from pathlib import Path

from repro_torch.backend import ARCH_WIDTHS, NOT_PORTED
from repro_torch.core.cpuutil import CpuSampler, cpu_budget
from repro_torch.core.devmodel import DeviceModel
from repro_torch.core.engine import EngineConfig, ServingSystem
from repro_torch.profiling import (ProfilingConfig, critical_path_summary,
                                   events_from_stats, export_chrome_trace,
                                   format_phase_summary, format_summary,
                                   phase_summary)
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.slo import SLOMix, parse_slo_mix


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--cores", type=int, default=1)
    ap.add_argument("--pool-width", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rps", type=float, default=8.0)
    ap.add_argument("--words", type=int, default=400,
                    help="prompt length in words")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--async-sched", action="store_true")
    ap.add_argument("--yield-every", type=int, default=64)
    ap.add_argument("--backend", default="emulated",
                    choices=("emulated", "torch") + NOT_PORTED,
                    help="worker executor (docs/backends.md); torch runs the "
                         "paged surrogate through the paged decode "
                         "attention kernel (cpu and hybrid are not ported "
                         "yet)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch backend only: where the workers run")
    ap.add_argument("--arch", default=None, choices=sorted(ARCH_WIDTHS),
                    help="torch backend only: size the surrogate at this "
                         "model's published widths (default: the toy "
                         "4 heads / 2 kv heads / head_dim 16 / vocab 256)")
    ap.add_argument("--max-decode-seqs", type=int, default=0,
                    help="decode-tier capacity: max decode slots per step "
                         "(0 = uncapped; round-robin under the cap)")
    ap.add_argument("--kv-capacity", type=int, default=0,
                    help="KV capacity in token slots (default: 4M emulated; "
                         "64K with the torch backend, since its page pools "
                         "are dense)")
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--preemption-policy", default="recompute",
                    choices=("recompute", "swap", "adaptive"),
                    help="what happens to a victim's computed KV under "
                         "memory pressure (docs/preemption.md): recompute "
                         "drops + re-prefills it, swap parks it in host "
                         "memory, adaptive picks per request from the "
                         "device model's swap-bandwidth calibration")
    ap.add_argument("--swap-capacity", type=int, default=0,
                    help="host swap tier size in token slots "
                         "(default: same as --kv-capacity)")
    ap.add_argument("--copy-streams", type=int, default=0,
                    help="async copy engine (docs/copy_engine.md): number "
                         "of DMA-style streams hiding swap/restore "
                         "transfers behind compute; 0 = serialized "
                         "transfers (charged inline)")
    ap.add_argument("--t-submit-per-copy", type=float, default=5e-6,
                    help="CPU seconds to submit one copy descriptor — the "
                         "CPU-starvation knob: large values erode the "
                         "overlap back to the serialized cost")
    ap.add_argument("--multi-step", type=int, default=1,
                    help="multi-step dispatch (docs/multi_step.md): "
                         "decode-steady batches run up to k decode "
                         "iterations per broadcast/barrier round trip; "
                         "1 = per-step dispatch")
    ap.add_argument("--kv-dtype", default="float32",
                    choices=("float32", "int8"),
                    help="KV pool precision (docs/spec_decode.md): int8 "
                         "quarters the fp32 KV bytes, with per-page scales")
    ap.add_argument("--per-tier-macros", action="store_true",
                    help="allow macro plans while prefill chunks are in "
                         "flight (per-tier eligibility, docs/multi_step.md)")
    ap.add_argument("--victim-selection", default="lifo",
                    choices=("lifo", "cheapest"),
                    help="preemption victim choice: most recently admitted "
                         "(lifo, vLLM-style) or cheapest-to-evict under "
                         "the active policy")
    ap.add_argument("--no-delta-tables", action="store_true",
                    help="broadcast full per-request block tables every "
                         "step instead of the delta encoding")
    ap.add_argument("--ring-slot-bytes", type=int, default=0,
                    help="override the auto-sized broadcast slot")
    ap.add_argument("--devmodel", default=None,
                    help="JSON devmodel calibration ({'device_model': "
                         "{...}}) for the emulated backend")
    ap.add_argument("--replicas", type=int, default=1,
                    help="fleet mode is not ported yet: only 1 is accepted")
    ap.add_argument("--slo-mix", default="",
                    help="SLO latency classes (docs/slo.md): tag "
                         "submissions per 'interactive:0.3,batch:0.7' "
                         "(deterministic largest-remainder proportions) "
                         "and run the scheduler class-aware — deadline-"
                         "ordered admission, rank-aware victims, overload "
                         "shedding; prints per-class attainment")
    ap.add_argument("--slo-blind", action="store_true",
                    help="with --slo-mix: tag the workload but keep the "
                         "scheduler class-BLIND (the baseline attainment "
                         "deltas are measured against)")
    ap.add_argument("--inject", default="",
                    help="speed-bump slowdown injection "
                         "(docs/profiling.md): 'site=delay_us,...' with "
                         "sites from repro_torch.profiling.SITES ('*' = "
                         "all); each named control-plane module sleeps "
                         "that long per call")
    ap.add_argument("--trace-out", default="",
                    help="write the merged engine/worker/api span "
                         "timeline as Chrome trace_event JSON to this "
                         "path (open in chrome://tracing or Perfetto) "
                         "and print the critical-path summary")
    args = ap.parse_args()

    if args.backend in NOT_PORTED:
        ap.error(f"--backend {args.backend} is not yet ported to "
                 f"repro_torch (ROADMAP.md, Queue 1)")
    if args.replicas > 1:
        ap.error("--replicas > 1 (fleet mode) is not yet ported to "
                 "repro_torch (ROADMAP.md, Queue 1)")
    got = cpu_budget(args.cores)
    if not args.kv_capacity:
        args.kv_capacity = (1 << 16) if args.backend == "torch" else (1 << 22)
    if args.devmodel:
        device = DeviceModel(
            **json.loads(Path(args.devmodel).read_text())["device_model"])
    else:
        device = DeviceModel(t_fixed=1e-3, t_prefill_tok=1e-6,
                             t_decode_seq=2e-5)
    device = dataclasses.replace(device, copy_streams=args.copy_streams,
                                 t_submit_per_copy=args.t_submit_per_copy)
    cfg = EngineConfig(
        tp_degree=args.tp, pool_width=args.pool_width,
        scheduler=SchedulerConfig(
            kv_capacity_tokens=args.kv_capacity,
            block_size=args.block_size,
            preemption_policy=args.preemption_policy,
            swap_capacity_tokens=args.swap_capacity or args.kv_capacity,
            max_decode_seqs=args.max_decode_seqs,
            victim_selection=args.victim_selection,
            delta_block_tables=not args.no_delta_tables,
            max_steps_per_dispatch=args.multi_step,
            per_tier_macros=args.per_tier_macros,
            slo_aware=bool(args.slo_mix) and not args.slo_blind,
            **device.preemption_calibration(),
            **device.copy_calibration()),
        device=device, backend=args.backend, kv_dtype=args.kv_dtype,
        torch_device=args.device, arch=args.arch,
        ring_slot_bytes=args.ring_slot_bytes,
        yield_every=args.yield_every, async_sched=args.async_sched,
        profiling=ProfilingConfig(inject=args.inject,
                                  trace=bool(args.trace_out)),
    )
    backend_desc = args.backend
    if args.backend == "torch":
        backend_desc += f"[{args.device}, {args.arch or 'toy widths'}]"
    print(f"[serve] tp={args.tp} cores={got} pool={args.pool_width} "
          f"backend={backend_desc} async_sched={args.async_sched} "
          f"preemption={args.preemption_policy} "
          f"victims={args.victim_selection} "
          f"copy_streams={args.copy_streams} "
          f"multi_step={args.multi_step} kv_dtype={args.kv_dtype}"
          + (f" slo_mix={args.slo_mix}"
             f"{' (blind)' if args.slo_blind else ''}"
             if args.slo_mix else ""))
    text = "the quick brown fox jumps over the lazy dog " * (args.words // 9)

    sys_ = ServingSystem(cfg).start()
    slo_mix = SLOMix(parse_slo_mix(args.slo_mix)) if args.slo_mix else None
    with CpuSampler(0.05) as sampler:
        t0 = time.perf_counter()
        for i in range(args.requests):
            target = t0 + i / args.rps
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            sys_.submit(text, max_new_tokens=args.max_new,
                        is_victim=(i % 5 == 0),
                        slo=slo_mix.next() if slo_mix else None)
        results = sys_.collect(args.requests, timeout=120.0)
    stats = sys_.shutdown()

    if args.trace_out:
        pairs = events_from_stats(stats)
        n = export_chrome_trace(pairs, args.trace_out)
        print(f"[trace] wrote {n} events to {args.trace_out} "
              f"(chrome://tracing / ui.perfetto.dev)")
        print(format_summary(critical_path_summary(pairs)))
        print(format_phase_summary(phase_summary(pairs)))

    finished = [r for r in results.values() if not r.get("timed_out")]
    ttfts = sorted(r["t_first_token"] - r["t_arrival"] for r in finished)
    toks = sorted(r["t_tokenize_done"] - r["t_tokenize_start"]
                  for r in finished)
    n_dead = len(results) - len(finished)
    print(f"[serve] completed {len(finished)}/{args.requests}"
          + (f" (timed out/rejected: {n_dead})" if n_dead else ""))
    if ttfts:
        print(f"[serve] TTFT p50={st.median(ttfts)*1e3:.1f}ms "
              f"p95={ttfts[int(0.95 * (len(ttfts) - 1))]*1e3:.1f}ms "
              f"max={ttfts[-1]*1e3:.1f}ms")
        print(f"[serve] tokenize p50={st.median(toks)*1e3:.2f}ms")
    workers = [s for s in stats if s["role"].startswith("worker")]
    for s in workers:
        dq = s["dequeue_wall"]
        if dq:
            print(f"[serve] {s['role']} dequeue p50="
                  f"{st.median(dq)*1e3:.2f}ms max={max(dq)*1e3:.1f}ms "
                  f"n={len(dq)}")
        ex = s["execute_wall"]
        if ex:
            print(f"[serve] {s['role']} startup={s['startup_s']:.2f}s "
                  f"execute p50={st.median(ex)*1e3:.2f}ms "
                  f"max={max(ex)*1e3:.1f}ms sum={sum(ex):.2f}s")
    eng = next((s for s in stats if s["role"] == "engine"), None)
    if eng:
        _print_slo(eng.get("slo"), "serve")
    if eng and eng["sched_cost"]:
        print(f"[serve] sched p50={st.median(eng['sched_cost'])*1e6:.0f}us "
              f"steps={len(eng['sched_cost'])} "
              f"barrier p50={st.median(eng['barrier_wall'])*1e3:.2f}ms")
    if eng and eng.get("payload_bytes"):
        pb = eng["payload_bytes"]
        print(f"[serve] broadcast payload p50={st.median(pb)/1024:.2f}KiB "
              f"max={max(pb)/1024:.2f}KiB total={sum(pb)/1024:.0f}KiB")
    print(f"[serve] cpu saturation(>=95%)={sampler.saturation_seconds():.1f}s")
    print(f"[serve] workers={len(workers)} kernel_launches="
          f"{sum(s.get('kernel_launches', 0) for s in workers)}")


def _print_slo(snap, tag: str) -> None:
    """Per-class SLO attainment (Scheduler.slo_snapshot format)."""
    if not snap:
        return
    for name, c in sorted(snap["classes"].items(),
                          key=lambda kv: -kv[1]["rank"]):
        ttft = c.get("ttft_attainment")
        tpot = c.get("tpot_attainment")
        print(f"[{tag}] slo {name} (rank {c['rank']}): "
              f"first={c['n_first']} "
              f"ttft_ok={f'{100 * ttft:.0f}%' if ttft is not None else '-'} "
              f"tpot_ok={f'{100 * tpot:.0f}%' if tpot is not None else '-'} "
              f"done={c['n_done']} timeouts={c['n_timeouts']}")
    if snap.get("shedding"):
        print(f"[{tag}] slo: overload shedding active at shutdown")


if __name__ == "__main__":
    main()
