"""The whole step (prefill and decode): the window's model operations over
its wall time over the card's bf16 peak, in %.  Operations are counted
from the configuration's shapes: each token's products through every
layer (attention projections, router, its top-k experts), causal
attention over the context held, and the logits of each sampled
position.  Moves ``gen_tok_s``."""
from portbench import roofline


def read(data, job):
    c, s = data["model_config"], data["spec"]
    B, S, n = s["rows"], s["prompt_tokens"], s["new_tokens"]
    per_batch = (roofline.prefill_flops(c, B, S)
                 + roofline.decode_flops(c, B, [S + i + 1
                                                for i in range(n)]))
    wall = data["t_close"] - data["t_open"]
    return 100.0 * data["batches"] * per_batch / wall / \
        roofline.PEAKS["bf16_flops"]
