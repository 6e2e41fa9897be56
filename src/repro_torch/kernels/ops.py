"""The kernels the models call: the twin of ``src/repro/kernels/ops.py``.

On the card each call launches the port's CUDA kernel; on the CPU (tests,
``--device cpu``) the wrapper computes the kernel's plain version.  The
choice follows the device of the tensors, with no switch, as the JAX
package's ``ops`` picks its Pallas kernel on a TPU and its oracle
elsewhere.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.mamba_scan import mamba1_scan


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Prefill attention (B3): see ``flash_attention_bhsd``."""
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
    and decode; ``h_out`` is where h_last goes (it may be ``h0``)."""
    return mamba1_scan(x, dt, Bt, Ct, A, h0, h_out)
