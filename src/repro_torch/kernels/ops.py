"""The kernels the models call: the twin of ``src/repro/kernels/ops.py``.

On the card each call launches the port's CUDA kernel; on the CPU (tests,
``--device cpu``) the wrapper computes the kernel's plain version.  The
choice follows the device of the tensors, with no switch, as the JAX
package's ``ops`` picks its Pallas kernel on a TPU and its oracle
elsewhere.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention_bhsd,
)
from repro_torch.kernels.mamba_scan import MambaScanFn, mamba1_scan


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Prefill and training attention (B3): see ``flash_attention_bhsd``;
    through ``FlashAttentionFn`` (its backward kernels) when an input
    requires a gradient."""
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return flash_attention_bhsd(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, cache_len, positions, *,
                     window: Optional[int] = None):
    """One-token attention over a cache (B2): see ``decode_attention_bhd``."""
    return decode_attention_bhd(q, k_cache, v_cache, cache_len, positions,
                                window=window)


def mamba_scan(x, dt, Bt, Ct, A, h0=None, h_out=None):
    """The Mamba-1 selective scan (B4): see ``mamba1_scan``.  Unlike the JAX
    package's ``mamba_scan``, it takes an initial state and returns
    (y, h_last), which ``models.ssm.mamba1_mix`` carries through prefill
    and decode; ``h_out`` is where h_last goes (it may be ``h0``).  When an
    input requires a gradient it runs through ``MambaScanFn`` (its backward
    kernel), which takes no ``h_out``: a cache entry advanced in place
    cannot be differentiated."""
    if _needs_grad(x, dt, Bt, Ct, A, h0):
        if h_out is not None:
            raise ValueError("the scan cannot write h_out in place when a "
                             "gradient is required")
        return MambaScanFn.apply(x, dt, Bt, Ct, A, h0)
    return mamba1_scan(x, dt, Bt, Ct, A, h0, h_out)
