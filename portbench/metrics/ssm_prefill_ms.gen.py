"""The Mamba-2 mixers (``models.ssm.mamba2_block``): their device time in
the traced batch's prefill, all layers together, in ms, from the
program's model spans (``profiling.model_span("ssm_mixer")``, CUDA events
around each layer's mixer).  None where the program has no such spans.
Moves ``gen_tok_s``."""


def read(data, job):
    return (data.get("prefill_spans_ms") or {}).get("ssm_mixer")
