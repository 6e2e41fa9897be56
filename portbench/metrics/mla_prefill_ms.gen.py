"""Latent attention (``models.mla.MLA.prefill``, decompressed, on B3): its
device time in the traced batch's prefill, all layers together, in ms,
from the program's model spans (``profiling.model_span("mla_mixer")``,
CUDA events around each layer's attention).  None where the program has
no such spans.  Moves ``gen_tok_s``."""


def read(data, job):
    return (data.get("prefill_spans_ms") or {}).get("mla_mixer")
