"""granite-4.0-h's model-path cell: ``gen``'s closed loop of whole batches
(prefill, restore into the fixed cache, greedy tokens through one captured
``Model.decode_multi``) on a hybrid of Mamba-2, attention and experts.

The configuration file holds the published ``config.json``'s keys at its
top level, cut as its ``reduced`` says; this module maps them onto the
program's ``HybridMoEConfig`` (``port_config``) and onto the reference's
sizes (``model_config``), and lays the reference's weights, drawn tensor
by tensor on the card, into a ``Model`` built on the meta device
(``build``): the model never exists twice.  Batches, the traced batch and
the check are ``gen``'s.  In a traced run the traced batch also runs with
the model's spans on (``repro_torch.profiling.start_model_spans``): the
device time of each kind of mixer and of the feed-forward in its prefill.
"""
from __future__ import annotations

import time
from typing import Dict, List

from portbench import traffic
from portbench.drivers.gen import (  # noqa: F401  (the driver's interface)
    _batch,
    _traced_batch,
    attempts,
    check,
    end_to_end,
    notes,
    reference,
)


def model_config(conf: Dict) -> Dict:
    """The reference's view of the configuration: the sizes it runs."""
    c, m = conf, 128
    d, H = c["hidden_size"], c["num_attention_heads"]
    if c["mamba_expand"] * d != c["mamba_n_heads"] * c["mamba_d_head"]:
        raise ValueError("mamba_n_heads x mamba_d_head is not "
                         "mamba_expand x hidden_size")
    return {"d_model": d, "n_heads": H,
            "n_kv_heads": c["num_key_value_heads"], "head_dim": d // H,
            "n_layers": c["num_hidden_layers"],
            "layer_types": list(c["layer_types"]),
            "vocab_size": c["vocab_size"],
            "padded_vocab": -(-c["vocab_size"] // m) * m,
            "n_experts": c["num_local_experts"],
            "top_k": c["num_experts_per_tok"],
            "d_ff_expert": c["intermediate_size"],
            "shared_d_ff": c["shared_intermediate_size"],
            "capacity_factor": c["capacity_factor"],
            "ssm_heads": c["mamba_n_heads"], "ssm_head_dim": c["mamba_d_head"],
            "d_state": c["mamba_d_state"], "n_groups": c["mamba_n_groups"],
            "d_conv": c["mamba_d_conv"], "chunk": c["mamba_chunk_size"],
            "norm_eps": c["rms_norm_eps"],
            "embedding_multiplier": c["embedding_multiplier"],
            "attention_multiplier": c["attention_multiplier"],
            "residual_multiplier": c["residual_multiplier"],
            "logits_scaling": c["logits_scaling"]}


def port_config(conf: Dict):
    """The program's ``HybridMoEConfig`` of ``conf["arch"]`` at this
    configuration's sizes."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(conf["arch"])
    mc = model_config(conf)
    return dataclasses.replace(
        cfg, n_layers=mc["n_layers"], layer_types=tuple(mc["layer_types"]),
        d_model=mc["d_model"], n_heads=mc["n_heads"],
        n_kv_heads=mc["n_kv_heads"], d_head=mc["head_dim"],
        vocab_size=mc["vocab_size"], d_ff=mc["d_ff_expert"],
        shared_d_ff=mc["shared_d_ff"],
        dtype=conf.get("torch_dtype", cfg.dtype),
        moe=dataclasses.replace(cfg.moe, n_experts=mc["n_experts"],
                                top_k=mc["top_k"],
                                d_ff_expert=mc["d_ff_expert"],
                                capacity_factor=mc["capacity_factor"]),
        ssm=dataclasses.replace(cfg.ssm, d_state=mc["d_state"],
                                d_conv=mc["d_conv"],
                                expand=conf["mamba_expand"],
                                head_dim=mc["ssm_head_dim"],
                                chunk=mc["chunk"], n_groups=mc["n_groups"]),
        embedding_multiplier=mc["embedding_multiplier"],
        attention_multiplier=mc["attention_multiplier"],
        residual_multiplier=mc["residual_multiplier"],
        logits_scaling=mc["logits_scaling"], norm_eps=mc["norm_eps"])


MAMBA = ("w_in", "conv_w", "conv_b", "dt_bias", "A_log", "D", "w_out")
MOE = ("router", "w_gate", "w_up", "w_down")
SHARED = {"shared_gate": "w_gate", "shared_up": "w_up",
          "shared_down": "w_down"}


def param_map(cfg) -> Dict[str, str]:
    """The program's parameter name of each of the benchmark's weights."""
    out = {"embed": "embed", "final_norm": "final_norm.scale"}
    period = cfg.period()
    for i, kind in enumerate(cfg.layer_types):
        p, q = f"stages.{cfg.family}.{i // period}.layer{i % period}.", \
            f"l{i}."
        out[q + "norm1"] = p + "norm1.scale"
        if kind == "mamba":
            out.update({q + n: p + "ssm." + n for n in MAMBA})
            out[q + "ssm_norm"] = p + "ssm.norm"
        else:
            out.update({q + n: p + "attn." + n
                        for n in ("wq", "wk", "wv", "wo")})
        out[q + "norm2"] = p + "norm2.scale"
        out.update({q + n: p + "moe." + n for n in MOE})
        out.update({q + n: p + "shared_mlp." + m for n, m in SHARED.items()})
    return out


def build(conf: Dict, seed: int, device):
    """The program's model holding the benchmark's weights, each drawn
    and laid into its parameter in turn."""
    import torch
    from repro_torch.models.model import Model
    cfg = port_config(conf)
    model = Model(cfg, device="meta").to_empty(device=device)
    params = dict(model.named_parameters())
    names = param_map(cfg)
    if set(names.values()) != set(params):
        raise ValueError("the program's parameters are not the benchmark's: "
                         f"{sorted(set(params) ^ set(names.values()))[:4]}")
    with torch.no_grad():
        for name, t in reference(conf).iter_weights(model_config(conf),
                                                    seed, device):
            p = params[names[name]]
            p.copy_(t.reshape(p.shape))
    return cfg, model


def run(job) -> Dict:
    import torch
    from repro_torch import profiling
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
    if job.trace:
        tokens = next_tokens()
        profiling.start_model_spans()
        try:
            if dev.type == "cuda":
                data["device_trace"] = _traced_batch(model, cfg, spec,
                                                     tokens, cache)
            else:
                _batch(model, cfg, spec, tokens, cache)[1].cpu()
        finally:
            spans = profiling.stop_model_spans()
        data["prefill_spans_ms"] = spans.totals()
    del model, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return data
