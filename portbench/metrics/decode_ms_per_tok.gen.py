"""The captured k-step loop (``Model.decode_multi``, ``kernels._graph``):
the window's ``decode_multi`` calls' time between CUDA events over the
steps they ran, in ms a step.  Moves ``gen_tok_s``."""


def read(data, job):
    ms = data.get("decode_ms")
    if not ms:
        return None
    return sum(ms) / (len(ms) * data["spec"]["new_tokens"])
