"""Kernel B2 (``kernels.decode_attention``, ``csrc/decode_attention.cu``):
its bound over its device time in the traced batch's decode, in %.
Each of the ``new_tokens`` steps calls it once a layer on every row over
the valid positions after that step's write (prompt + step + 1) of a
cache of prompt + new_tokens slots; the bound of each call is the larger
of its operations over the bf16 peak and its bytes over the memory
bandwidth.  The device time is the sum of the trace's decode-attention
kernels (the paged kernel B1 excluded), replayed graphs included.  Moves
``gen_tok_s``."""
from portbench import roofline


def is_b2(name: str) -> bool:
    return "decode_attention_kernel" in name and "paged" not in name


def read(data, job):
    tr = data.get("device_trace")
    if not tr:
        return None
    dev = sum(d for name, _, d in tr["ops"] if is_b2(name))
    if dev <= 0:
        return None
    c, s = data["model_config"], data["spec"]
    S, n = s["prompt_tokens"], s["new_tokens"]
    bound = 0.0
    for i in range(n):
        call = roofline.decode_call(s["rows"], S + i + 1, c["n_heads"],
                                    c["n_kv_heads"], c["head_dim"], S + n)
        bound += c["n_layers"] * roofline.bound_s(
            call["flops"], call["bytes"], roofline.PEAKS["bf16_flops"])
    return 100.0 * bound / dev
