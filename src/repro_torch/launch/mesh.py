"""The 1-D ``("data",)`` device mesh of a sharded engine.

A :class:`DataMesh` is an ordered tuple of torch devices, one per shard.
One process drives every shard (single-controller, as the reference's
``shard_map``): the engine, its plan cache and its snapshot are shared, and
each shard's program runs on its own device.  Devices may repeat — several
shards on one card, or on the CPU — which is how a mesh of any size runs
where fewer devices exist (the CPU tests; a 4-shard mesh on one card).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``devices[d]`` runs shard ``d``; ``axis_names`` names the mesh axis
    (``DynasparseEngine`` takes only ``("data",)``)."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a DataMesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_devices(device_type: str) -> int:
    """Devices of ``device_type`` this process can place a shard on: the
    visible cards for ``"cuda"``, one for the CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def make_data_mesh(n_devices: int, device="cuda") -> DataMesh:
    """1-D ``("data",)`` mesh over the first ``n_devices`` devices of
    ``device``'s type (cards ``0 .. n_devices - 1``; the CPU counts as one
    device).  Raises when fewer are visible — e.g. a snapshot made on an
    8-card host replayed on a 1-card one."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    avail = visible_devices(kind)
    if n_devices > avail:
        raise ValueError(
            f"requested a {n_devices}-device data mesh but only {avail} "
            f"{kind} device(s) are visible (build DataMesh((device,) * n) "
            f"to place n shards on one device)")
    if kind == "cuda":
        return DataMesh(tuple(torch.device("cuda", i)
                              for i in range(n_devices)))
    return DataMesh((torch.device(kind),))
