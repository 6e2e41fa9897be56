"""The roofline: the twin of ``src/repro/roofline``, on the H100."""
from repro_torch.roofline.collectives import (
    CollectiveCounter,
    collective_bytes,
)
from repro_torch.roofline.model import (
    H100_SXM,
    HardwareSpec,
    model_flops,
    roofline_terms,
)

__all__ = [
    "CollectiveCounter",
    "H100_SXM",
    "HardwareSpec",
    "collective_bytes",
    "model_flops",
    "roofline_terms",
]
