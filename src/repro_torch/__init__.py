"""HybridDNN in PyTorch: the port of ``repro`` to CUDA on NVIDIA Hopper.

The same 128-bit ISA, compiler, DSE and validate-once executor as the JAX
reference package, with every Pallas kernel on the served path replaced by
a CUDA C++ kernel written by hand for ``sm_90a`` (``kernels/``,
``csrc/``). Runs on a CUDA device unless the caller passes
``device="cpu"``. See README.md, "PyTorch port (H100)".
"""

__version__ = "0.1.0"
