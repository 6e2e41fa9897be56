"""Serving cells: the port's multi-process engine under an open-loop
schedule.

The system under test is ``repro_torch.core.engine.ServingSystem`` built
from the configuration file, exactly as ``repro_torch.launch.serve
--backend torch`` builds it: the tokenizer pool in this process, the
engine core and the workers forked from it, each worker's backend made by
``make_backend`` (wrapped by the recorder, ``drivers/recorder.py``).

Clock.  Set-up is everything until the window opens: imports, the kernel
library's build, the fork, the workers' start-up (CUDA context,
weights, every captured bucket of the k-step loop), and ``warmup_s``
seconds of the cell's own traffic, all served.  The window then opens
and requests are sent at their scheduled times; a request's time to
first token runs from when it was due to the engine's first token.
After the window closes the harness waits for every request that was due
in it (up to ``wait_s``), so a late answer counts its lateness; one that
never comes is missing.

Only this process and its children run the cell: they are pinned to the
configuration's ``cpus`` logical CPUs, and a host with fewer fails the
run.  In a traced run each worker traces its device activity
(``drivers/recorder.py``), and the union of the two workers' kernel
intervals is the card's busy time.
"""
from __future__ import annotations

import dataclasses
import importlib
import multiprocessing
import os
import pickle
import queue
import random
import threading
import time
from pathlib import Path
from typing import Dict, List

from portbench import stats, traffic
from portbench.drivers.recorder import recording
from portbench.reference.bpe import serving_tokenizer


class HostTooSmall(RuntimeError):
    pass


def pin(n_cpus: int) -> None:
    """Restrict this process and its future children to its first
    ``n_cpus`` logical CPUs (``repro_torch.core.cpuutil.cpu_budget``'s
    rule), or raise when it has fewer."""
    avail = sorted(os.sched_getaffinity(0))
    if len(avail) < n_cpus:
        raise HostTooSmall(f"the cell runs on {n_cpus} logical CPUs and this "
                           f"process may use {len(avail)}")
    os.sched_setaffinity(0, avail[:n_cpus])


def engine_config(conf: Dict, *, trace: bool, device: str):
    """The engine as ``launch.serve`` builds it from its flags, with the
    configuration's settings in place of the flags."""
    from repro_torch.core.devmodel import DeviceModel
    from repro_torch.core.engine import EngineConfig
    from repro_torch.profiling import ProfilingConfig
    from repro_torch.serving.scheduler import SchedulerConfig
    dm = dataclasses.replace(
        DeviceModel(t_fixed=1e-3, t_prefill_tok=1e-6, t_decode_seq=2e-5),
        copy_streams=0, t_submit_per_copy=5e-6)
    s = conf["serving"]
    return EngineConfig(
        tp_degree=s["tp"], pool_width=s["pool_width"],
        scheduler=SchedulerConfig(
            max_num_seqs=s["max_num_seqs"],
            max_tokens_per_step=s["max_tokens_per_step"],
            prefill_chunk=s["prefill_chunk"],
            enable_prefix_cache=s["enable_prefix_cache"],
            kv_capacity_tokens=s["kv_capacity_tokens"],
            block_size=s["block_size"],
            preemption_policy=s["preemption_policy"],
            swap_capacity_tokens=s["kv_capacity_tokens"],
            max_steps_per_dispatch=s["max_steps_per_dispatch"],
            **dm.preemption_calibration(), **dm.copy_calibration()),
        device=dm, backend="torch", kv_dtype=s["kv_dtype"],
        torch_device=device, arch=s.get("arch"),
        yield_every=s["yield_every"], async_sched=s["async_sched"],
        profiling=ProfilingConfig(trace=trace))


def _submit_all(system, reqs, t_open: float, sent: Dict[int, tuple],
                lag: List[float]) -> None:
    """Send each request at its due time (open loop)."""
    for i, r in enumerate(reqs):
        due = t_open + r.t_due
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        lag.append(max(0.0, time.perf_counter() - due))
        rid = system.submit(r.text, max_new_tokens=r.max_new)
        sent[rid] = (i, due)


def _collect(system, rids, deadline: float) -> None:
    """Wait until every request in ``rids`` has a result or until
    ``deadline``."""
    want = set(rids)
    while not want <= system.results.keys() and time.perf_counter() < deadline:
        system.collect(len(system.results) + 1,
                       timeout=max(0.05, min(1.0, deadline
                                             - time.perf_counter())))


def _wait_for(out_dir: str, kind: str, n: int, deadline: float) -> None:
    """Until the workers have written ``n`` files of ``kind``."""
    while (len(list(Path(out_dir).glob(f"{kind}-*.pkl"))) < n
           and time.perf_counter() < deadline):
        time.sleep(0.1)


def _shutdown(system) -> List[dict]:
    """``system.shutdown()`` with its stats queue read meanwhile:
    ``ServingSystem.shutdown`` joins the engine before it reads the queue,
    and an engine whose stats outgrow the pipe cannot exit until they are
    read."""
    drained: List[dict] = []
    done = threading.Event()

    def drain() -> None:
        while not done.is_set():
            try:
                drained.append(system.stats_q.get(timeout=0.2))
            except queue.Empty:
                continue

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        stats = system.shutdown()
    finally:
        done.set()
        reader.join()
    return drained + stats


def run(job) -> Dict:
    """One run of a serving cell; returns what ``run.py`` reports."""
    import repro_torch.backend as backend_mod
    from repro_torch.core.engine import ServingSystem
    from repro_torch.profiling import events_from_stats

    conf, spec = job.config, job.traffic
    s = conf["serving"]
    out_dir = job.run_dir
    window = traffic.open_loop(spec, job.seed, job.seconds)
    warm = traffic.warmup(spec, job.seed)
    if job.pin:
        pin(conf["cpus"])
    max_blocks = -(-(spec["prompt_tokens"]["max"]
                     + spec["output_tokens"]["max"]) // s["block_size"])
    flush = multiprocessing.get_context("fork").RawValue("b", 0)
    original = backend_mod.make_backend
    backend_mod.make_backend = recording(
        original, out_dir, trace=job.trace and job.device == "cuda",
        buckets=dict(rows=s["max_num_seqs"], blocks=max_blocks,
                     steps=s["max_steps_per_dispatch"]),
        fault=job.fault, flush=flush)
    system = None
    worker_stats: List[dict] = []
    sent: Dict[int, tuple] = {}
    lag: List[float] = []
    after: Dict[str, float] = {}
    try:
        system = ServingSystem(engine_config(conf, trace=job.trace,
                                             device=job.device))
        system.start()
        warm_sent: Dict[int, tuple] = {}
        _submit_all(system, warm, time.perf_counter(), warm_sent, [])
        _collect(system, list(warm_sent), time.perf_counter()
                 + spec["wait_s"])
        if not set(warm_sent) <= system.results.keys():
            raise RuntimeError("warm-up requests were not all served")
        t_open = time.perf_counter()
        job.setup_done(t_open)
        sender = threading.Thread(target=_submit_all,
                                  args=(system, window, t_open, sent, lag))
        sender.start()
        t_close = t_open + job.seconds
        while sender.is_alive():
            system.collect(len(system.results) + 1, timeout=0.5)
        sender.join()
        _collect(system, list(sent), t_close + spec["wait_s"])
        after["answered"] = time.perf_counter() - t_close
        results = {rid: dict(system.results.get(rid, {})) for rid in sent}
        # the records are written while the workers run one last plan
        flush.value = 1
        last = system.submit(warm[0].text, max_new_tokens=1)
        _collect(system, [last], time.perf_counter() + 300)
        _wait_for(out_dir, "worker", s["tp"], time.perf_counter() + 60)
        after["records"] = time.perf_counter() - t_close
        if job.trace and job.device == "cuda":
            _wait_for(out_dir, "trace", s["tp"], time.perf_counter() + 240)
            after["traces"] = time.perf_counter() - t_close
    finally:
        if system is not None:
            worker_stats = _shutdown(system)
            if after:
                after["shut_down"] = time.perf_counter() - t_close
        backend_mod.make_backend = original
    records = [pickle.loads(p.read_bytes())
               for p in sorted(Path(out_dir).glob("worker-*.pkl"))]
    traces = [pickle.loads(p.read_bytes())
              for p in sorted(Path(out_dir).glob("trace-*.pkl"))]
    spans = events_from_stats(worker_stats)
    data = {"window": window, "sent": sent, "results": results,
            "t_open": t_open, "t_close": t_close, "lag": lag,
            "records": records, "spans": spans,
            "after_window_s": after,
            "captures_in_window": sum(r["captures"] - r["captures_ready"]
                                      for r in records)}
    if records and "device_name" in records[0]:
        data["device_name"] = records[0]["device_name"]
        # one card: the workers' peaks together
        data["memory_peak_bytes"] = sum(r["memory_peak_bytes"]
                                        for r in records)
    if job.trace and traces:
        data["device_trace"] = {
            "t0": t_open, "t1": t_close,
            "ops": [op for ops in traces for op in ops],
            "phases": [(f"{role}.{ev.site}", ev.t0, ev.t0 + ev.dur)
                       for role, ev in spans if not ev.instant]}
    return data


def end_to_end(data: Dict) -> Dict[str, float]:
    """TTFT and TPOT medians and tails over every request due in the window
    (a request never answered is a miss, which sorts above every answered
    one), and the tokens per second made in it."""
    t0, t1 = data["t_open"], data["t_close"]
    ttft, tpot, made = [], [], 0.0
    for rid, (_, due) in data["sent"].items():
        r = data["results"].get(rid)
        if not _answered(r):
            ttft.append(stats.MISSING)
            tpot.append(stats.MISSING)
            continue
        n = r["n_generated"]
        ttft.append(r["t_first_token"] - due)
        tpot.append((r["t_done"] - r["t_first_token"]) / (n - 1)
                    if n > 1 else 0.0)
        made += stats.tokens_in_window(r["t_first_token"], r["t_done"], n,
                                       t0, t1)
    return {"ttft_p50_ms": stats.percentile(ttft, 50) * 1e3,
            "tpot_p50_ms": stats.percentile(tpot, 50) * 1e3,
            "ttft_p95_ms": stats.percentile(ttft, 95) * 1e3,
            "tpot_p95_ms": stats.percentile(tpot, 95) * 1e3,
            "serve_tok_s": made / (t1 - t0)}


def _answered(r) -> bool:
    return bool(r) and not r.get("timed_out") and bool(r.get("t_first_token"))


def attempts(data: Dict):
    """Requests due in the window, and those never answered."""
    return len(data["sent"]), sum(
        1 for rid in data["sent"] if not _answered(data["results"].get(rid)))


def notes(data: Dict) -> Dict:
    """How late the sender ran, the latency tails (per-layer metrics, too
    spread to bound: ``PERF.md``), the prompt tokens the engine saw, and
    the graphs the k-step loop captured inside the window (0 when set-up
    made every bucket), and when, after the window closed, the
    window's requests were all answered, the workers' records and traces
    written and the engine shut down (seconds; what a run costs beyond its
    window and set-up)."""
    from portbench import stats as st
    lag = data["lag"] or [0.0]
    tails = end_to_end(data)
    return {"sender_lag_p99_ms": st.percentile(lag, 99) * 1e3,
            "ttft_p95_ms": tails["ttft_p95_ms"],
            "tpot_p95_ms": tails["tpot_p95_ms"],
            "n_prompt": sum(r.get("n_prompt", 0)
                            for r in data["results"].values() if r),
            "captures_in_window": data["captures_in_window"],
            "after_window_s": data["after_window_s"]}


def check(data: Dict, conf: Dict, spec: Dict, seed: int, device,
          readings: bool = False) -> Dict:
    """Hold the served tokens to the plain reference that the
    configuration names (``reference/<name>.py``): every request due in
    the window must have been answered; for a sample of the answered ones,
    drawn from the seed with the longest in it, each worker's prompt
    tokens must be the text's tokens, each must have sampled as many
    tokens as the engine counted, and no sampled token's reference logit
    may lie further below the reference's best than the limit.  With
    ``readings`` the control (the reference in TF32) is read at the same
    positions and judged by the same checks, its own ``correct`` beside
    its readings."""
    import torch
    ref = importlib.import_module(
        f"portbench.reference.{conf['reference']}")

    lim = spec["limits"]
    done = {rid: r for rid, r in data["results"].items() if _answered(r)}
    unanswered = len(data["sent"]) - len(done)
    rng = random.Random(seed)
    order = sorted(done, key=lambda rid: (-done[rid]["n_generated"], rid))
    pick = [order[0]] if order else []
    rest = order[1:]
    rng.shuffle(rest)
    budget = spec["check_tokens"] - (done[pick[0]]["n_generated"]
                                     if pick else 0)
    for rid in rest:
        if budget <= 0:
            break
        pick.append(rid)
        budget -= done[rid]["n_generated"]
    tok = serving_tokenizer()
    texts = {rid: data["window"][data["sent"][rid][0]].text for rid in pick}
    model = ref.Surrogate(conf["serving"]["widths"],
                      conf["serving"]["weights_seed"], device)
    prompt_bad = count_bad = 0
    gaps, ctl_gaps, n_tokens = [], [], 0
    for rid in pick:
        prompt = tok.encode(texts[rid])
        seen: Dict[tuple, tuple] = {}    # the workers' streams are alike
        for rec in data["records"]:
            events = rec["streams"].get(rid, [])
            segments = _segments(events)
            if segments[-1][0][:len(prompt)] != prompt:
                prompt_bad += 1
            emitted = sum(len(e) for _, e in segments)
            if emitted - _prefill_samples(events, len(prompt)) != \
                    done[rid]["n_generated"]:
                count_bad += 1
            for stream, emits in segments:
                if not emits:
                    continue
                lengths = [n for n, _ in emits]
                key = (tuple(stream), tuple(lengths))
                if key not in seen:
                    logits = model.logits(stream, lengths)
                    ctl = (model.logits(stream, lengths, "tf32").argmax(-1)
                           if readings else None)
                    seen[key] = (logits, logits.max(dim=-1).values, ctl)
                logits, best, ctl = seen[key]
                served = torch.tensor([t for _, t in emits], device=device)
                gaps.append(best - logits.gather(
                    1, served[:, None] % model.vocab)[:, 0])
                n_tokens += len(emits)
                if readings:
                    ctl_gaps.append(best - logits.gather(
                        1, ctl[:, None])[:, 0])
        del seen
    widest = torch.cat(gaps).max().item() if gaps else float("nan")
    missing = conf["serving"]["tp"] - len(data["records"])
    checks = [("unanswered", unanswered, 0),
              ("workers_unrecorded", missing, 0),
              ("prompt_mismatch", prompt_bad, 0),
              ("count_mismatch", count_bad, 0),
              ("widest_gap", widest, lim["widest_gap"])]
    sound = (unanswered == 0 and missing == 0 and prompt_bad == 0
             and count_bad == 0)
    out = {"checks": checks, "checked_requests": len(pick),
           "checked_tokens": n_tokens,
           "correct": sound and bool(gaps) and widest <= lim["widest_gap"]}
    if gaps:
        out["readings"] = _readings(torch.cat(gaps))
    if readings:
        ctl = _readings(torch.cat(ctl_gaps)) if ctl_gaps else None
        out["control"] = ctl and dict(
            ctl, correct=sound and ctl["widest_gap"] <= lim["widest_gap"])
    return out


def _readings(gaps) -> Dict[str, float]:
    """The widest gap, the mean gap and the share of samples whose token
    is not the reference's best."""
    return {"widest_gap": gaps.max().item(),
            "mean_gap": gaps.float().mean().item(),
            "miss_share": (gaps > 0).float().mean().item()}


def _prefill_samples(events, n_prompt: int) -> int:
    """Samples taken at the end of a prefill chunk that did not finish
    the prompt (the engine does not serve them)."""
    return sum(1 for e in events if e[0] == "e" and e[1] < n_prompt)


def _segments(events):
    """Split a request's events where a write changes a token already
    written (a recomputed prefix may differ): each segment's stream and
    the samples taken over it."""
    segs = []
    stream: List[int] = []
    emits: List[tuple] = []
    for ev in events:
        if ev[0] == "w":
            start, toks = ev[1], ev[2]
            end = start + len(toks)
            if any(stream[p] != t for p, t in zip(range(start, min(end,
                   len(stream))), toks)):
                segs.append((list(stream), emits))
                emits = []
            if len(stream) < end:
                stream.extend([0] * (end - len(stream)))
            stream[start:end] = toks
        else:
            emits.append((ev[1], ev[2]))
    segs.append((stream, emits))
    return segs
