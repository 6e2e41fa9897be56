"""Model-path cells: offline batch generation through the port's
``Model.prefill`` and ``Model.decode_multi``.

Set-up draws the weights on the card from the seed (``make_weights`` of
the reference the configuration names), lays them into a
``repro_torch.models.model.Model`` built on the meta device, allocates the
decode cache once at the batch's full length, and runs ``warmup_batches``
whole batches (the first captures the decode loop's CUDA graph).  The
window is a closed loop of whole batches: draw a batch of prompts,
prefill it, restore the prefill's cache into the fixed cache in place,
greedy-decode ``new_tokens`` through one captured ``decode_multi``, and
read the tokens back to the host.  The window holds
every batch that started before ``seconds`` had passed.

In a traced run the window is timed with CUDA events around each call,
and after it closes one more batch runs under ``torch.profiler`` (device
activity only): that batch is the traced window.
"""
from __future__ import annotations

import importlib
import random
import time
from typing import Dict, List

from portbench import traffic
from portbench.drivers.recorder import device_ops


def reference(conf: Dict):
    """The plain reference the configuration names (``reference/<name>.py``):
    it draws the weights and computes the logits."""
    return importlib.import_module(f"portbench.reference.{conf['reference']}")


def model_config(conf: Dict) -> Dict:
    """The reference's view of the configuration: the sizes it runs."""
    c = conf["model"]
    m = 128
    return {"d_model": c["hidden_size"], "n_heads": c["num_attention_heads"],
            "n_kv_heads": c["num_key_value_heads"],
            "head_dim": c["hidden_size"] // c["num_attention_heads"],
            "n_layers": c["num_hidden_layers"],
            "vocab_size": c["vocab_size"],
            "padded_vocab": -(-c["vocab_size"] // m) * m,
            "n_experts": c["num_local_experts"],
            "top_k": c["num_experts_per_tok"],
            "d_ff_expert": c["intermediate_size"],
            "capacity_factor": c["capacity_factor"],
            "rope_theta": c["rope_theta"]}


def port_config(conf: Dict):
    """The program's ``ModelConfig`` of ``conf["arch"]`` at this
    configuration's sizes."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(conf["arch"])
    mc = model_config(conf)
    return dataclasses.replace(
        cfg, d_model=mc["d_model"], n_heads=mc["n_heads"],
        n_kv_heads=mc["n_kv_heads"], n_layers=mc["n_layers"],
        vocab_size=mc["vocab_size"], rope_theta=mc["rope_theta"],
        d_head=None,
        moe=dataclasses.replace(cfg.moe, n_experts=mc["n_experts"],
                                top_k=mc["top_k"],
                                d_ff_expert=mc["d_ff_expert"],
                                capacity_factor=mc["capacity_factor"]))


def param_map(cfg) -> Dict[str, str]:
    """The program's parameter name of each of the benchmark's weights."""
    stage = cfg.family
    out = {"embed": "embed", "final_norm": "final_norm.scale"}
    for i in range(cfg.n_layers):
        p = f"stages.{stage}.{i}.layer0."
        out.update({f"l{i}.norm1": p + "norm1.scale",
                    f"l{i}.wq": p + "attn.wq", f"l{i}.wk": p + "attn.wk",
                    f"l{i}.wv": p + "attn.wv", f"l{i}.wo": p + "attn.wo",
                    f"l{i}.norm2": p + "norm2.scale",
                    f"l{i}.router": p + "moe.router",
                    f"l{i}.w_gate": p + "moe.w_gate",
                    f"l{i}.w_up": p + "moe.w_up",
                    f"l{i}.w_down": p + "moe.w_down"})
    return out


def build(conf: Dict, seed: int, device):
    """The program's model holding the benchmark's weights."""
    import torch
    from repro_torch.models.model import Model
    cfg = port_config(conf)
    mc = model_config(conf)
    model = Model(cfg, device="meta").to_empty(device=device)
    params = dict(model.named_parameters())
    names = param_map(cfg)
    if set(names.values()) != set(params):
        raise ValueError("the program's parameters are not the benchmark's: "
                         f"{sorted(set(params) ^ set(names.values()))[:4]}")
    weights = reference(conf).make_weights(mc, seed, device)
    with torch.no_grad():
        for ours, theirs in names.items():
            p = params[theirs]
            p.copy_(weights[ours].reshape(p.shape))
    del weights
    return cfg, model


def _batch(model, cfg, spec, tokens, cache, events=None, marks=None):
    """One batch: prefill, restore into ``cache``, decode_multi.  Returns
    (first token [B, 1], decoded [B, n]) on the device.  ``events``: four
    CUDA events recorded around the prefill and the decode; ``marks``: a
    list that gets the host's time after each call returns."""
    import torch
    S, n = spec["prompt_tokens"], spec["new_tokens"]
    if events is not None:
        events[0].record()
    logits, pre = model.prefill(tokens)
    if events is not None:
        events[1].record()
    first = logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    if marks is not None:
        marks.append(time.perf_counter())
    for stage, layers in pre.items():
        for key, entry in layers.items():
            for name, t in entry.items():
                cache[stage][key][name][:, :, :S].copy_(t)
    del pre, logits
    if marks is not None:
        marks.append(time.perf_counter())
    if events is not None:
        events[2].record()
    out, _, _ = model.decode_multi(first, cache, S, n)
    if events is not None:
        events[3].record()
    if marks is not None:
        marks.append(time.perf_counter())
    return first, out


def run(job) -> Dict:
    import torch
    from repro_torch.models.model import cache_specs

    conf, spec = job.config, job.traffic
    dev = torch.device(job.device)
    cfg, model = build(conf, job.seed, dev)
    if job.fault is not None:
        job.fault(model)
    B, S, n = spec["rows"], spec["prompt_tokens"], spec["new_tokens"]
    cache = {st: {k: {nm: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                      for nm, t in e.items()} for k, e in layers.items()}
             for st, layers in cache_specs(cfg, B, S + n).items()}
    index = 0

    def next_tokens():
        nonlocal index
        t = traffic.batch_tokens(spec, job.seed, index, cfg.vocab_size, dev)
        index += 1
        return t

    for _ in range(spec["warmup_batches"]):
        _, out = _batch(model, cfg, spec, next_tokens(), cache)
        out.cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    served: Dict[int, tuple] = {}
    timing: List[List] = []
    t_open = time.perf_counter()
    job.setup_done(t_open)
    while time.perf_counter() < t_open + job.seconds:
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(4)]
              if job.trace and dev.type == "cuda" else None)
        b = index
        first, out = _batch(model, cfg, spec, next_tokens(), cache, ev)
        served[b] = (first.cpu(), out.cpu())
        if ev is not None:
            timing.append(ev)
    t_close = time.perf_counter()
    data = {"t_open": t_open, "t_close": t_close, "served": served,
            "model_config": model_config(conf), "spec": spec,
            "batches": len(served)}
    if dev.type == "cuda":
        data["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        data["device_name"] = torch.cuda.get_device_name()
    if timing:
        data["prefill_ms"] = [e[0].elapsed_time(e[1]) for e in timing]
        data["decode_ms"] = [e[2].elapsed_time(e[3]) for e in timing]
    if job.trace and dev.type == "cuda":
        data["device_trace"] = _traced_batch(model, cfg, spec, next_tokens(),
                                             cache)
    del model, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return data


def _traced_batch(model, cfg, spec, tokens, cache) -> Dict:
    """One more batch under ``torch.profiler`` (device activity): each
    device operation's name and interval on the host's clock, the traced
    window, and what the host was doing when (``phases``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    marks = [time.perf_counter()]
    _, out = _batch(model, cfg, spec, tokens, cache, marks=marks)
    out.cpu()
    marks.append(time.perf_counter())
    prof.stop()
    names = ("prefill call", "restore", "decode_multi call",
             "waiting for the tokens")
    return {"t0": marks[0], "t1": marks[-1], "ops": device_ops(prof),
            "phases": [(names[i], marks[i], marks[i + 1])
                       for i in range(len(marks) - 1)]}


def check(data: Dict, conf: Dict, spec: Dict, seed: int, device,
          readings: bool = False) -> Dict:
    """Hold ``check_batches`` batches of the window, drawn from the seed,
    to the plain reference: at every served position (each row's last
    prompt position and each decode step's), the gap by which the served
    token's reference logit lies below the reference's best.  The number
    compared is the mean gap over those positions (``PERF.md`` says why
    not the widest).  With ``readings`` the control (the reference with
    fp8 products) is read at the same positions and judged by the same
    limit, its own ``correct`` beside its readings."""
    import torch
    ref = reference(conf)
    mc = data["model_config"]
    S, n = spec["prompt_tokens"], spec["new_tokens"]
    pick = random.Random(seed).sample(sorted(data["served"]),
                                      min(spec["check_batches"],
                                          len(data["served"])))
    w = ref.make_weights(mc, seed, device)
    groups = [(0, S)] + [(S + i, S + i + 1) for i in range(n)]
    positions = list(range(S - 1, S + n))
    gaps, ctl_gaps = [], []
    for b in pick:
        first, out = (t.to(device) for t in data["served"][b])
        prompt = traffic.batch_tokens(spec, seed, b, mc["vocab_size"],
                                      device)
        fed = torch.cat([prompt, first, out[:, :-1]], dim=1)
        served = torch.cat([first, out], dim=1).long()          # [B, n+1]
        logits = ref.logits_at(w, mc, fed, groups, positions)
        best = logits.max(dim=-1).values
        gaps.append((best - logits.gather(2, served[..., None])[..., 0])
                    .flatten())
        if readings:
            ctl = ref.logits_at(w, mc, fed, groups, positions,
                                "fp8").argmax(-1)
            ctl_gaps.append((best - logits.gather(2, ctl[..., None])[..., 0])
                            .flatten())
        del logits, best
    gaps = torch.cat(gaps)
    mean_gap = gaps.mean().item()
    lim = spec["limits"]
    outcome = {"checks": [("mean_gap", mean_gap, lim["mean_gap"])],
               "checked_tokens": gaps.numel(), "checked_batches": pick,
               "readings": _readings(gaps),
               "correct": mean_gap <= lim["mean_gap"]}
    if readings:
        ctl = _readings(torch.cat(ctl_gaps))
        outcome["control"] = dict(
            ctl, correct=ctl["mean_gap"] <= lim["mean_gap"])
    return outcome


def _readings(gaps) -> Dict[str, float]:
    """The widest gap, the mean gap and the share of positions whose
    token is not the reference's best, over a tensor of gaps."""
    return {"widest_gap": gaps.max().item(),
            "mean_gap": gaps.float().mean().item(),
            "miss_share": (gaps > 0).float().mean().item()}


def end_to_end(data: Dict) -> Dict[str, float]:
    """Tokens generated (each row's first token and its decoded ones) over
    the window's wall time."""
    spec = data["spec"]
    made = data["batches"] * spec["rows"] * (spec["new_tokens"] + 1)
    return {"gen_tok_s": made / (data["t_close"] - data["t_open"])}


def attempts(data: Dict):
    return data["batches"] * data["spec"]["rows"], 0


def notes(data: Dict) -> Dict:
    return {"batches": data["batches"]}
