"""The paper's attacker/victim experiment on the real multi-process engine.

  PYTHONPATH=src python -m repro_torch.launch.serve_contention \
      [--backend torch|emulated] [--device cuda|cpu] [--arch qwen2-0.5b]

Runs the instrumented control plane (tokenizer pool -> EngineCore -> shm
broadcast ring -> TP workers) twice: once idle (victim alone), once under
attacker load, and prints the victim TTFT degradation plus the contended
dequeue statistics (the live, small-scale analogue of Figs 7/13; the DES,
``repro_torch.launch.core_sweep_sim``, scales this to 5..64 cores).

The twin of ``examples/serve_contention.py``.  ``--backend emulated`` is
the reference's run exactly (the same device model, two workers, a pool
of four, ``yield_every`` 64).  ``--backend torch``, the default, runs the
same experiment on ``TorchBackend``: the paged surrogate through the
paged decode attention kernel on the card (``--device cuda``; ``cpu``
only when asked), at ``--arch``'s widths (default: the toy widths), with
the KV capacity ``launch.serve`` gives a physical leaf.  The clock starts
at submission, as in the reference, and the workers are forked when the
engine starts, so a victim TTFT includes the workers' start-up: each
worker's ``startup_s`` and kernel launches are printed before its run's
summary line.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.backend import ARCH_WIDTHS
from repro_torch.core.devmodel import DeviceModel
from repro_torch.core.engine import EngineConfig, ServingSystem
from repro_torch.serving.scheduler import SchedulerConfig


def run_once(cfg: EngineConfig, attackers: int, label: str) -> dict:
    sys_ = ServingSystem(cfg).start()
    attacker_text = "tokenize me repeatedly please " * 600
    victim_text = "short victim request " * 40
    try:
        for _ in range(attackers):
            sys_.submit(attacker_text, max_new_tokens=2)
        time.sleep(0.05)
        vid = sys_.submit(victim_text, max_new_tokens=4, is_victim=True)
        results = sys_.collect(attackers + 1, timeout=120.0)
        victim = results.get(vid)
        if victim is None or victim.get("timed_out"):
            raise RuntimeError(f"victim timed out under load ({label})")
    finally:
        stats = sys_.shutdown()
    workers = sorted((s for s in stats if s["role"].startswith("worker")),
                     key=lambda s: s["role"])
    dq = [w for s in workers for w in s["dequeue_wall"]]
    for s in workers:
        print(f"[{label}] {s['role']} startup={s['startup_s']:.2f}s "
              f"kernel_launches={s['kernel_launches']}")
    rec = {
        "label": label,
        "victim_ttft_ms": (victim["t_first_token"] - victim["t_arrival"]) * 1e3,
        "victim_tokenize_ms":
            (victim["t_tokenize_done"] - victim["t_tokenize_start"]) * 1e3,
        "dequeue_p95_ms":
            sorted(dq)[int(0.95 * (len(dq) - 1))] * 1e3 if dq else 0.0,
    }
    print(f"[{label}] victim TTFT={rec['victim_ttft_ms']:.1f}ms "
          f"tokenize={rec['victim_tokenize_ms']:.1f}ms "
          f"dequeue_p95={rec['dequeue_p95_ms']:.2f}ms")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "emulated"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the torch backend runs")
    ap.add_argument("--arch", default=None, choices=sorted(ARCH_WIDTHS),
                    help="the torch backend's surrogate widths (default: "
                         "the toy widths)")
    args = ap.parse_args(argv)
    cfg = EngineConfig(
        tp_degree=2, pool_width=4,
        device=DeviceModel(t_fixed=5e-4, t_prefill_tok=2e-7,
                           t_decode_seq=1e-5),
        yield_every=64,
    )
    if args.backend == "torch":
        # dense page pools: 64K slots, as launch.serve gives a physical leaf
        cfg = dataclasses.replace(
            cfg, scheduler=SchedulerConfig(kv_capacity_tokens=1 << 16),
            backend="torch", torch_device=args.device, arch=args.arch)
    quiet = run_once(cfg, 0, "no-load")
    loaded = run_once(cfg, 12, "attacker-load")
    slow = loaded["victim_ttft_ms"] / max(quiet["victim_ttft_ms"], 1e-9)
    print(f"victim TTFT degradation under attacker load: {slow:.2f}x "
          f"(paper: CPU-starved configs degrade 1.36-5.40x and beyond)")


if __name__ == "__main__":
    main()
