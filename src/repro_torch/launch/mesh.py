"""Device meshes for serving. Each is a function: importing this module
touches no device.

A mesh is a :class:`repro_torch.compat.Mesh`, an array of torch devices in
which a device may repeat (each position is one replica). ``device_type``
picks the local devices: ``"cuda"`` (the default; raises without a card)
``"cpu"`` (one device) or ``"meta"`` (placeholder positions, for the
dry-run: a production mesh with no card).
"""
from __future__ import annotations

from repro_torch.compat import Mesh, local_devices, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod. Raises
    ``ValueError`` when fewer devices are local; ``device_type="meta"``
    builds it of placeholder positions."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(device_type: str = "cuda") -> Mesh:
    """``(1, n)`` over ``("data", "model")``: every local device."""
    devices = local_devices(device_type)
    return make_mesh((1, len(devices)), ("data", "model"), devices=devices)


def make_fleet_mesh(n_devices: int | None = None, *,
                    device_type: str = "cuda") -> Mesh:
    """``(n,)`` over ``("batch",)``: the serving fleet's topology.

    The sharded executor splits the request batch over every mesh axis,
    so a flat ``("batch",)`` mesh is data-parallel serving, one shard of
    every device batch per device; position ``i`` is device ``i``.
    ``n_devices`` caps the fleet to the first N local devices (``None`` =
    all of them)."""
    devices = local_devices(device_type)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(
                f"n_devices={n_devices} outside [1, {len(devices)}] local "
                f"devices")
        devices = devices[:n_devices]
    return make_mesh((len(devices),), ("batch",), devices=devices)
