"""The whole step of a model of latent attention beside experts (prefill
and decode): the window's needed operations over its wall time over the
card's bf16 peak, in %.  Operations by part (``portbench/roofline_mla.py``):
the latent attention's products at their real widths, its pairs at the
query's and the value's head dims (not B3's padding), the absorbed decode,
the dense MLP, the router, ``top_k`` experts and shared experts, and the
logits of each sampled position.  None where the configuration has no
latent attention.  Moves ``gen_tok_s``."""
from portbench import roofline_mla


def read(data, job):
    c = data["model_config"]
    if "kv_lora_rank" not in c:
        return None
    wall = data["t_close"] - data["t_open"]
    return 100.0 * data["batches"] * roofline_mla.batch_flops(
        c, data["spec"]) / wall / roofline_mla.PEAKS["bf16_flops"]
