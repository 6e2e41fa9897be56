"""The whole step of a hybrid of Mamba-2, attention and experts (prefill
and decode): the window's operations over its wall time over the card's
bf16 peak, in %.  Operations by layer kind (``portbench/
roofline_hybrid.py``): the Mamba-2 projections, conv and chunked SSD, the
attention projections and pairs, the router, ``top_k`` experts and shared
expert of every layer, and the logits of each sampled position.  None
where the configuration has no ``layer_types``.  Moves ``gen_tok_s``."""
from portbench import roofline_hybrid


def read(data, job):
    c = data["model_config"]
    if "layer_types" not in c:
        return None
    wall = data["t_close"] - data["t_open"]
    return 100.0 * data["batches"] * roofline_hybrid.batch_flops(
        c, data["spec"]) / wall / roofline_hybrid.PEAKS["bf16_flops"]
