"""The feed-forward of a hybrid layer (the experts and the shared expert,
``models.model.HybridMoELayer._ffn``): its device time in the traced
batch's prefill, all layers together, in ms, from the program's model
spans (``profiling.model_span("ffn")``).  None where the program has no
such spans.  Moves ``gen_tok_s``."""


def read(data, job):
    return (data.get("prefill_spans_ms") or {}).get("ffn")
