"""Serving driver: the real multi-process engine under a request workload.

  PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \
      --arch qwen2-0.5b --tp 2 --requests 8

Runs the instrumented control plane (API-server tokenizer pool -> EngineCore
-> shm broadcast -> workers) on this machine, restricted to ``--cores``
logical CPUs (the paper's salloc-style budget), and reports TTFT /
tokenize / dequeue statistics.  With ``--backend torch`` every worker runs
the paged surrogate on the card (``--device cuda``, the default) through
the paged decode attention kernel, and it prints the kernel's
launches summed over the workers; ``--backend cpu`` runs the surrogate
with a plain attention on the CPU, ``--backend hybrid`` splits prefill and
decode over two of them, ``--speculative-k`` drafts and verifies, and
``--replicas`` serves from a fleet of engines behind a router.

Ported from ``src/repro/launch/serve.py``: imports rewritten to
``repro_torch``; ``torch`` in place of ``jax``, with ``--device`` (where
every ``torch`` leaf runs) and ``--arch`` (the widths of every physical
leaf).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics as st
import time
from pathlib import Path

from repro_torch.backend import ARCH_WIDTHS, PHYSICAL
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
                    choices=("emulated", "torch", "cpu", "hybrid"),
                    help="worker executor (docs/backends.md); torch runs the "
                         "paged surrogate through the paged decode "
                         "attention kernel, cpu a plain attention on the "
                         "CPU (keep --kv-capacity small for both), hybrid "
                         "splits prefill/decode across two child backends")
    ap.add_argument("--prefill-backend", default="emulated",
                    choices=("emulated", "torch", "cpu"),
                    help="hybrid only: accelerator-tier child executing "
                         "the prefill sub-plan")
    ap.add_argument("--decode-backend", default="emulated",
                    choices=("emulated", "torch", "cpu"),
                    help="hybrid only: CPU-tier child executing the decode "
                         "sub-plan (emulated children get the device's "
                         "cpu_tier cost model)")
    ap.add_argument("--decode-slowdown", type=float, default=8.0,
                    help="hybrid only: CPU-tier decode slowdown applied to "
                         "an emulated decode child (DeviceModel.cpu_tier)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every torch leaf (backend, hybrid child or "
                         "draft) runs")
    ap.add_argument("--arch", default=None, choices=sorted(ARCH_WIDTHS),
                    help="size every physical leaf's surrogate at this "
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
                         "of DMA-style streams hiding swap/restore and "
                         "hybrid-handoff transfers behind compute; 0 = "
                         "serialized transfers (charged inline)")
    ap.add_argument("--t-submit-per-copy", type=float, default=5e-6,
                    help="CPU seconds to submit one copy descriptor — the "
                         "CPU-starvation knob: large values erode the "
                         "overlap back to the serialized cost")
    ap.add_argument("--multi-step", type=int, default=1,
                    help="multi-step dispatch (docs/multi_step.md): "
                         "decode-steady batches run up to k decode "
                         "iterations per broadcast/barrier round trip; "
                         "1 = per-step dispatch")
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="speculative decode (docs/spec_decode.md): draft "
                         "up to k candidate tokens per request on the "
                         "draft backend and verify them in one batched "
                         "step; 0 = off.  Takes precedence over "
                         "--multi-step for eligible batches")
    ap.add_argument("--draft-backend", default="",
                    choices=("", "torch", "cpu", "emulated"),
                    help="speculative draft child (default: cpu when the "
                         "target is physical, emulated otherwise); must "
                         "match the target's physicality")
    ap.add_argument("--kv-dtype", default="float32",
                    choices=("float32", "int8"),
                    help="decode-tier KV pool precision "
                         "(docs/spec_decode.md): int8 quarters the fp32 KV "
                         "bytes, with per-page scales; under hybrid the "
                         "prefill->decode handoff quantizes")
    ap.add_argument("--per-tier-macros", action="store_true",
                    help="allow macro/speculative plans while prefill "
                         "chunks are in flight (per-tier eligibility, "
                         "docs/multi_step.md) — natural fit for hybrid, "
                         "where the tiers execute concurrently")
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
                    help="fleet mode (docs/fleet.md): run N full engine "
                         "replicas behind a FleetRouter; --cores is the "
                         "whole-fleet budget")
    ap.add_argument("--routing", default="affinity",
                    choices=("affinity", "round-robin", "p2c"),
                    help="fleet request routing policy (docs/fleet.md)")
    ap.add_argument("--sessions", type=int, default=4,
                    help="fleet mode: distinct session prefixes in the "
                         "workload (each request leads with its session's "
                         "prefix — what affinity routing keys on)")
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

    if (args.backend == "hybrid"
            and ((args.prefill_backend in PHYSICAL)
                 != (args.decode_backend in PHYSICAL))):
        # fail fast here: make_backend would raise the same error, but
        # post-fork inside every worker, leaving the engine to hang on
        # the completion board until its timeout
        ap.error("hybrid children must be both physical (torch/cpu) or "
                 "both emulated")
    if args.speculative_k > 0 and args.draft_backend:
        target_physical = (args.backend in PHYSICAL
                           or (args.backend == "hybrid"
                               and args.prefill_backend in PHYSICAL))
        if (args.draft_backend in PHYSICAL) != target_physical:
            # same fail-fast rationale as the hybrid-children check above
            ap.error("--draft-backend must match the target's physicality "
                     "(physical target -> torch/cpu draft)")
    got = cpu_budget(args.cores)
    physical = {args.backend} | ({args.prefill_backend, args.decode_backend}
                                 if args.backend == "hybrid" else set())
    if not args.kv_capacity:
        args.kv_capacity = ((1 << 16) if physical & set(PHYSICAL)
                            else (1 << 22))
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
            speculative_k=args.speculative_k,
            per_tier_macros=args.per_tier_macros,
            slo_aware=bool(args.slo_mix) and not args.slo_blind,
            t_swap_block_decode=(
                device.cpu_tier(
                    decode_slowdown=args.decode_slowdown).t_swap_block
                if args.backend == "hybrid" else -1.0),
            **device.preemption_calibration(),
            **device.copy_calibration()),
        device=device, backend=args.backend,
        prefill_backend=args.prefill_backend,
        decode_backend=args.decode_backend,
        decode_slowdown=args.decode_slowdown,
        draft_backend=args.draft_backend,
        kv_dtype=args.kv_dtype,
        torch_device=args.device, arch=args.arch,
        ring_slot_bytes=args.ring_slot_bytes,
        yield_every=args.yield_every, async_sched=args.async_sched,
        pressure_every=(4 if args.replicas > 1 else 0),
        profiling=ProfilingConfig(inject=args.inject,
                                  trace=bool(args.trace_out)),
    )
    backend_desc = args.backend
    if args.backend == "hybrid":
        backend_desc += (f"[{args.prefill_backend}->prefill, "
                         f"{args.decode_backend}->decode]")
    if "torch" in cfg.leaves():
        backend_desc += f" torch on {args.device}"
    if physical & set(PHYSICAL):
        backend_desc += f" at {args.arch or 'toy widths'}"
    print(f"[serve] tp={args.tp} cores={got} pool={args.pool_width} "
          f"backend={backend_desc} async_sched={args.async_sched} "
          f"preemption={args.preemption_policy} "
          f"victims={args.victim_selection} "
          f"copy_streams={args.copy_streams} "
          f"multi_step={args.multi_step} "
          f"speculative_k={args.speculative_k} kv_dtype={args.kv_dtype}"
          + (f" slo_mix={args.slo_mix}"
             f"{' (blind)' if args.slo_blind else ''}"
             if args.slo_mix else ""))
    text = "the quick brown fox jumps over the lazy dog " * (args.words // 9)

    if args.replicas > 1:
        _serve_fleet(args, cfg, text)
        return

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
    _print_workers(stats, "serve")
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
    _print_launches(stats, "serve")


def _print_workers(stats, tag: str) -> None:
    """Per worker: dequeue waits, start-up and execute times, and a
    composite backend's counters (hybrid handoffs, speculative drafts)."""
    for s in stats:
        if not s["role"].startswith("worker"):
            continue
        dq = s["dequeue_wall"]
        if dq:
            print(f"[{tag}] {s['role']} dequeue p50="
                  f"{st.median(dq)*1e3:.2f}ms max={max(dq)*1e3:.1f}ms "
                  f"n={len(dq)}")
        ex = s["execute_wall"]
        if ex:
            print(f"[{tag}] {s['role']} startup={s['startup_s']:.2f}s "
                  f"execute p50={st.median(ex)*1e3:.2f}ms "
                  f"max={max(ex)*1e3:.1f}ms sum={sum(ex):.2f}s")
        if s.get("composite"):
            print(f"[{tag}] {s['role']} " + " ".join(
                f"{k[2:]}={v}" for k, v in s["composite"].items()))


def _print_launches(stats, tag: str) -> None:
    workers = [s for s in stats if s["role"].startswith("worker")]
    print(f"[{tag}] workers={len(workers)} kernel_launches="
          f"{sum(s.get('kernel_launches', 0) for s in workers)} "
          f"graph_captures={sum(s.get('graph_captures', 0) for s in workers)}"
          f" graph_capture_s="
          f"{sum(s.get('graph_capture_s', 0.0) for s in workers):.6f} "
          f"graph_replays={sum(s.get('graph_replays', 0) for s in workers)}")


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


def _serve_fleet(args, cfg: EngineConfig, base_text: str) -> None:
    """Fleet mode: N engine replicas behind a FleetRouter (docs/fleet.md).

    The workload leads each request with a per-session word prefix, so the
    affinity policy has real routing keys; round-robin/p2c ignore them.
    Each replica's workers make their own CUDA context when they run on
    the card."""
    from repro_torch.fleet import (FleetAutoscaler, FleetServingFrontend,
                                   ReplicaSignals)
    fleet = FleetServingFrontend([cfg] * args.replicas,
                                 routing=args.routing).start()
    slo_mix = SLOMix(parse_slo_mix(args.slo_mix)) if args.slo_mix else None
    with CpuSampler(0.05) as sampler:
        t0 = time.perf_counter()
        for i in range(args.requests):
            target = t0 + i / args.rps
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            sid = i % max(1, args.sessions)
            text = (f"session {sid} shared context preamble " * 8
                    + base_text)
            fleet.submit(text, max_new_tokens=args.max_new,
                         is_victim=(i % 5 == 0), session=sid,
                         slo=slo_mix.next() if slo_mix else None)
        results = fleet.collect(args.requests, timeout=120.0)
    pressures = fleet.pressure()
    router = fleet.router.stats()
    all_stats = fleet.shutdown()

    if args.trace_out:
        flat = [dict(s, role=f"r{idx}/{s['role']}")
                for idx, stats in enumerate(all_stats) for s in stats]
        pairs = events_from_stats(flat)
        n = export_chrome_trace(pairs, args.trace_out)
        print(f"[trace] wrote {n} events ({args.replicas} replicas) to "
              f"{args.trace_out}")
        print(format_summary(critical_path_summary(pairs)))
        print(format_phase_summary(phase_summary(pairs)))

    finished = [r for r in results.values()
                if not r.get("timed_out") and r.get("t_first_token")]
    ttfts = sorted(r["t_first_token"] - r["t_arrival"] for r in finished)
    n_dead = len(results) - len(finished)
    print(f"[fleet] completed {len(finished)}/{args.requests}"
          + (f" (timed out/rejected: {n_dead})" if n_dead else ""))
    if ttfts:
        print(f"[fleet] TTFT p50={st.median(ttfts)*1e3:.1f}ms "
              f"p95={ttfts[int(0.95 * (len(ttfts) - 1))]*1e3:.1f}ms "
              f"max={ttfts[-1]*1e3:.1f}ms")
    per_replica = [0] * args.replicas
    for r in results.values():
        if "replica" in r:
            per_replica[r["replica"]] += 1
    print(f"[fleet] routing={args.routing} per-replica requests="
          f"{per_replica} affinity_hits={router['n_affinity_hits']} "
          f"session_hits={router['n_session_hits']} "
          f"diversions={router['n_pressure_diversions']}")
    for idx, p in enumerate(pressures):
        if p is not None:
            print(f"[fleet] replica{idx} pressure: free_blocks="
                  f"{p.free_blocks}/{p.total_blocks} queue={p.queue_depth} "
                  f"preempted={p.n_preempted} timed_out={p.n_timed_out}")
    # autoscaling signal from the fleet-level CPU-starvation metrics
    sat = sampler.saturation_seconds()
    wall = max(1e-9, time.perf_counter() - t0)
    n_res = max(1, len(results))
    sig = ReplicaSignals(
        cpu_saturation=min(1.0, sat / wall),
        timeout_rate=n_dead / n_res,
        preempt_rate=(sum(p.n_preempted for p in pressures
                          if p is not None) / n_res),
        kv_pressure=max((p.kv_pressure for p in pressures
                         if p is not None), default=0.0))
    scaler = FleetAutoscaler(args.replicas)
    rec = scaler.observe([sig] * args.replicas)
    for _ in range(scaler.cfg.window - 1):
        rec = scaler.observe([sig] * args.replicas)
    print(f"[fleet] cpu saturation(>=95%)={sat:.1f}s of {wall:.1f}s; "
          f"autoscaler: {rec.action} -> {rec.target} replicas "
          f"({rec.reason})")
    for idx, stats in enumerate(all_stats):
        eng = next((s for s in stats if s["role"] == "engine"), None)
        if eng:
            _print_slo(eng.get("slo"), f"fleet r{idx}")
        if eng and eng["sched_cost"]:
            print(f"[fleet] replica{idx} sched p50="
                  f"{st.median(eng['sched_cost'])*1e6:.0f}us "
                  f"steps={len(eng['sched_cost'])}")
        _print_workers(stats, f"fleet r{idx}")
        _print_launches(stats, f"fleet r{idx}")


if __name__ == "__main__":
    main()
