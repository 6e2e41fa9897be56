"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Keeps the reference's layout and names (``serving``, ``core``, ``backend``,
``kernels``, ``tokenizer``, ``launch``, ``slo``, ``profiling``) so that each
module's counterpart in ``src/repro`` is easy to find.  Imports ``torch``,
never ``jax``, and nothing from ``repro``: framework-free modules are
copied, not imported.  Entry points run on the card unless the caller asks
for the CPU.
"""
