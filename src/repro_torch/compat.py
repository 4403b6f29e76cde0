"""Device resolution, numerics and host/device conversion for the PyTorch
port.

The port runs on a CUDA card unless the caller asks for the CPU. It never
falls back to the CPU on its own: a missing card is an error that names the
explicit ``device="cpu"`` spelling.

cuDNN runs float32 convolutions in TF32 on Hopper by default, which keeps
about three decimal digits and misses the reference's 1e-4 budget, so every
path that puts the port on a CUDA device turns TF32 off for both cuDNN and
matmuls first.
"""
from __future__ import annotations

import numpy as np
import torch

# the PE implementations every entry point takes: plain aten ops, or the
# hand-written CUDA kernels (their plain versions on CPU tensors)
BACKENDS = ("torch", "hopper")


def resolve_backend(backend: str) -> str:
    """Validate the PE backend name ("torch" or "hopper")."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: expected one of {BACKENDS}")
    return backend


def use_strict_fp32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when CUDA is absent.

    A CUDA result also switches the process to strict fp32 numerics
    (:func:`use_strict_fp32`).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on a CUDA device "
                "by default — pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        use_strict_fp32()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: expected cuda or cpu")
    return device


def to_tensor(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """An array or tensor -> a tensor on ``device`` (arrays are copied, so
    read-only buffers such as exported JAX arrays are fine).

    Without ``dtype``, integer types are kept as they are (int8 weights and
    activations, int32 biases) and floats become float32; ``dtype`` casts
    to that type instead."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    if dtype is None:
        dtype = a.dtype if not a.dtype.is_floating_point else torch.float32
    return a.to(device=device, dtype=dtype)


def to_numpy(a) -> np.ndarray:
    """A tensor (on any device) or array -> a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
