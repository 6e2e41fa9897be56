"""Where the port runs: the card by default, the CPU only when asked."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one it raises rather than falling
    back to the CPU.  Only an explicit ``"cpu"`` runs on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card by "
                               "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
