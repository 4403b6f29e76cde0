"""Device resolution, numerics and host/device conversion for the PyTorch
port.

The port runs on a CUDA card unless the caller asks for the CPU. It never
falls back to the CPU on its own: a missing card is an error that names the
explicit ``device="cpu"`` spelling.

cuDNN runs float32 convolutions in TF32 on Hopper by default, which keeps
about three decimal digits and misses the reference's 1e-4 budget, so every
path that puts the port on a CUDA device turns TF32 off for both cuDNN and
matmuls first.

A device mesh (:class:`Mesh`, :func:`make_mesh`) is an array of torch
devices with one name per axis, the port's counterpart of
``jax.sharding.Mesh``. Each position is one replica, and a device may
repeat: two positions on one card are two replicas that take turns on it.
A mesh of ``meta`` positions is a placeholder: it holds no device, and the
dry-run (``launch/dryrun.py``) builds the production meshes with it, as
the reference pins 512 placeholder host devices.
"""
from __future__ import annotations

import math
from typing import Sequence

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
    A ``meta`` device (the dry-run's placeholder positions, on which only
    fake tensors are made) is kept as it is.

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
    elif device.type not in ("cpu", "meta"):
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


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """The local devices of one type: every CUDA card (raising, as
    :func:`resolve_device` does, when there is none), the one CPU, or the
    one ``meta`` placeholder."""
    if device_type in ("cpu", "meta"):
        return [torch.device(device_type)]
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}: "
                         f"expected cuda, cpu or meta")
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A device mesh: ``devices``, a numpy object array of
    ``torch.device`` (one replica per position; a device may repeat), and
    ``axis_names``, one per dimension. ``shape`` maps each axis name to its
    size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            self.devices[idx] = _mesh_device(d)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{n}={k}' for n, k in self.shape.items())}"
                f"; {[str(d) for d in self.devices.flat]})")


def _mesh_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              devices: Sequence | None = None,
              device_type: str = "cuda") -> Mesh:
    """A :class:`Mesh` of shape ``axis_shapes`` over ``devices`` (default:
    the local devices of ``device_type``), whose count must equal the
    shape's product, as ``jax.make_mesh`` requires. ``device_type="meta"``
    fills every position with the placeholder."""
    n = math.prod(axis_shapes)
    if devices is None and device_type == "meta":
        devices = local_devices("meta") * n
    devices = (local_devices(device_type) if devices is None
               else list(devices))
    if n != len(devices):
        raise ValueError(f"number of devices {len(devices)} must equal the "
                         f"product of mesh_shape {tuple(axis_shapes)} ({n})")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(axis_shapes)), axis_names)
