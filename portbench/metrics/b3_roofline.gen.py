"""Kernel B3 (``kernels.flash_attention``, ``csrc/flash_attention_wgmma.cu``
or ``csrc/flash_attention.cu``): its bound over its device time in the
traced batch's prefill, in %.  The bound is the larger of the operations
over the bf16 peak and the bytes over the memory bandwidth, counted from
the prefill's shapes (one call a layer), each input byte read once; the
device time is the sum of the trace's forward flash-attention kernels.
Moves ``gen_tok_s``."""
from portbench import roofline


def is_b3(name: str) -> bool:
    return ("flash_attention_wgmma_kernel" in name
            or "flash_attention_kernel" in name) and "bwd" not in name


def read(data, job):
    tr = data.get("device_trace")
    if not tr:
        return None
    dev = sum(d for name, _, d in tr["ops"] if is_b3(name))
    if dev <= 0:
        return None
    c, s = data["model_config"], data["spec"]
    call = roofline.flash_call(s["rows"], s["prompt_tokens"], c["n_heads"],
                               c["n_kv_heads"], c["head_dim"])
    bound = c["n_layers"] * roofline.bound_s(
        call["flops"], call["bytes"], roofline.PEAKS["bf16_flops"])
    return 100.0 * bound / dev
