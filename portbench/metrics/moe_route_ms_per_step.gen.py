"""The experts' dispatch and combine (``kernels.moe_dispatch``,
``csrc/moe_dispatch.cu``): the device time of their two kernels in the
traced batch, replayed graphs included, over its ``new_tokens`` decode
steps, in ms a step.  They run only where the program's moe layers take
the fused path (decode-sized calls on the card), so a value says that path
engaged in the measured program, and what its two kernels cost; ``None``
where neither ran, as in a program without them.  Moves ``gen_tok_s``."""

KERNELS = ("moe_dispatch_kernel", "moe_combine_kernel")


def read(data, job):
    tr = data.get("device_trace")
    if not tr:
        return None
    dev = sum(d for name, _, d in tr["ops"]
              if any(k in name for k in KERNELS))
    if dev <= 0:
        return None
    return 1e3 * dev / data["spec"]["new_tokens"]
