"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see ``paged_decode_attention``); ``_build`` compiles the CUDA
sources in ``repro_torch/csrc`` with nvcc at first use."""
