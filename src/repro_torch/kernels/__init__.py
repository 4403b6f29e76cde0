"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
one per Pallas kernel of the reference's served path, each beside its
plain PyTorch version."""
