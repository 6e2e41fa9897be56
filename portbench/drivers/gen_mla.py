"""DeepSeek-V2's model-path cell: ``gen``'s closed loop of whole batches
(prefill, restore into the fixed cache, greedy tokens through one captured
``Model.decode_multi``) on multi-head latent attention beside experts.

The configuration file holds the published ``config.json``'s keys at its
top level; this module maps them onto the program's ``MLAConfig``
(``port_config``) and onto the reference's sizes (``model_config``), and
lays the reference's weights, drawn tensor by tensor on the card, into a
``Model`` built on the meta device (``build``), the rotary columns of
``W_q`` and ``W_kv_a`` reordered from the published interleaved order into
the program's (``models.mla.rope_from_interleaved``).  Batches, the traced
batch and the check are ``gen``'s.  In a traced run the traced batch also
runs with the model's spans on (``repro_torch.profiling.
start_model_spans``): the device time of the latent attention and of the
feed-forward in its prefill.
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
    if c["q_lora_rank"] is not None:
        raise ValueError("the program runs latent attention without q "
                         "compression (q_lora_rank null)")
    if c["num_key_value_heads"] != c["num_attention_heads"]:
        raise ValueError("latent attention decompresses a key and a value "
                         "for every head")
    if (c["scoring_func"], c["topk_method"], c["routed_scaling_factor"]) \
            != ("softmax", "greedy", 1):
        raise ValueError("the program routes by softmax and greedy top-k, "
                         "the gates unscaled")
    ys = c["rope_scaling"]
    return {"d_model": c["hidden_size"], "n_heads": c["num_attention_heads"],
            "n_layers": c["num_hidden_layers"],
            "first_k_dense_replace": c["first_k_dense_replace"],
            "vocab_size": c["vocab_size"],
            "padded_vocab": -(-c["vocab_size"] // m) * m,
            "kv_lora_rank": c["kv_lora_rank"],
            "qk_nope_head_dim": c["qk_nope_head_dim"],
            "qk_rope_head_dim": c["qk_rope_head_dim"],
            "v_head_dim": c["v_head_dim"],
            "rope_theta": c["rope_theta"],
            "rope_scaling": {k: ys[k] for k in (
                "factor", "original_max_position_embeddings", "beta_fast",
                "beta_slow", "mscale", "mscale_all_dim")},
            "d_ff": c["intermediate_size"],
            "n_experts": c["n_routed_experts"],
            "top_k": c["num_experts_per_tok"],
            "d_ff_expert": c["moe_intermediate_size"],
            "shared_d_ff": c["n_shared_experts"] * c["moe_intermediate_size"],
            "n_shared_experts": c["n_shared_experts"],
            "renormalize": c["norm_topk_prob"],
            "capacity_factor": c["capacity_factor"],
            "norm_eps": c["rms_norm_eps"]}


def port_config(conf: Dict):
    """The program's ``MLAConfig`` of ``conf["arch"]`` at this
    configuration's sizes."""
    import dataclasses
    from repro_torch.configs import YarnScaling, get_config
    cfg = get_config(conf["arch"])
    mc = model_config(conf)
    ys = mc["rope_scaling"]
    return dataclasses.replace(
        cfg, n_layers=mc["n_layers"],
        first_k_dense_replace=mc["first_k_dense_replace"],
        d_model=mc["d_model"], n_heads=mc["n_heads"],
        n_kv_heads=mc["n_heads"],
        d_head=mc["qk_nope_head_dim"] + mc["qk_rope_head_dim"],
        vocab_size=mc["vocab_size"], d_ff=mc["d_ff"],
        kv_lora_rank=mc["kv_lora_rank"],
        qk_nope_head_dim=mc["qk_nope_head_dim"],
        qk_rope_head_dim=mc["qk_rope_head_dim"],
        v_head_dim=mc["v_head_dim"], rope_theta=mc["rope_theta"],
        rope_scaling=YarnScaling(
            factor=ys["factor"],
            original_max_position=ys["original_max_position_embeddings"],
            beta_fast=ys["beta_fast"], beta_slow=ys["beta_slow"],
            mscale=ys["mscale"], mscale_all_dim=ys["mscale_all_dim"]),
        norm_eps=mc["norm_eps"], dtype=conf.get("torch_dtype", cfg.dtype),
        moe=dataclasses.replace(cfg.moe, n_experts=mc["n_experts"],
                                top_k=mc["top_k"],
                                d_ff_expert=mc["d_ff_expert"],
                                n_shared_experts=mc["n_shared_experts"],
                                renormalize=mc["renormalize"],
                                capacity_factor=mc["capacity_factor"]))


ATTN = ("wq", "wkv_a", "wkv_b", "wo")
MLP = {"mlp_gate": "mlp.w_gate", "mlp_up": "mlp.w_up",
       "mlp_down": "mlp.w_down"}
MOE = {n: "moe." + n for n in ("router", "w_gate", "w_up", "w_down")}
SHARED = {"shared_gate": "shared_mlp.w_gate", "shared_up": "shared_mlp.w_up",
          "shared_down": "shared_mlp.w_down"}


def param_map(cfg) -> Dict[str, str]:
    """The program's parameter name of each of the benchmark's weights."""
    out = {"embed": "embed", "final_norm": "final_norm.scale",
           "lm_head": "lm_head"}
    k = cfg.first_k_dense_replace
    for i in range(cfg.n_layers):
        p = (f"stages.mla_dense.{i}.layer0." if i < k
             else f"stages.mla_moe.{i - k}.layer0.")
        q = f"l{i}."
        out.update({q + "norm1": p + "norm1.scale",
                    q + "kv_norm": p + "attn.kv_norm.scale",
                    q + "norm2": p + "norm2.scale"})
        out.update({q + n: p + "attn." + n for n in ATTN})
        for ref, ours in (MLP.items() if i < k
                          else [*MOE.items(), *SHARED.items()]):
            out[q + ref] = p + ours
    return out


def build(conf: Dict, seed: int, device):
    """The program's model holding the benchmark's weights, each drawn
    and laid into its parameter in turn."""
    import torch
    from repro_torch.models.mla import rope_from_interleaved
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
            t = t.reshape(p.shape)
            if name.endswith((".wq", ".wkv_a")):
                t = rope_from_interleaved(t, cfg.qk_rope_head_dim)
            p.copy_(t)
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
