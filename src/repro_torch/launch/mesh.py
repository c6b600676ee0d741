"""Device meshes: the 1-D ``("data",)`` mesh of a sharded engine and the
N-D mesh with named axes of the LM distribution layer.

A :class:`DataMesh` is an ordered tuple of torch devices, one per shard.
One process drives every shard (single-controller, as the reference's
``shard_map``): the engine, its plan cache and its snapshot are shared, and
each shard's program runs on its own device.  Devices may repeat — several
shards on one card, or on the CPU — which is how a mesh of any size runs
where fewer devices exist (the CPU tests; a 4-shard mesh on one card).

A :class:`Mesh` is the same idea in N dimensions: an array of torch
devices in the mesh's shape with one name per axis, e.g. ``("data",
"model")``, ``("pod", "data", "model")`` or ``("pipe",)``; devices may
repeat here too.  ``with mesh:`` makes it the current mesh, which
:func:`repro_torch.distributed.sharding.constrain` and resharding restores
read.  :func:`make_mesh_for_devices` and the deprecated
:func:`make_production_mesh` are the reference's factories over the
visible devices.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import warnings

import numpy as np
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


class Mesh:
    """``devices``: an array (nested sequences or a numpy object array) of
    torch devices whose shape is the mesh's; ``axis_names`` names its axes
    in order.  ``shape`` maps each axis to its size, as a jax mesh's
    does."""

    def __init__(self, devices, axis_names):
        src = np.array(devices, dtype=object)
        if src.ndim != len(axis_names) or len(set(axis_names)) != src.ndim:
            raise ValueError(f"a mesh of shape {src.shape} needs "
                             f"{src.ndim} distinct axis names, got "
                             f"{tuple(axis_names)}")
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        if arr.size == 0:
            raise ValueError("a Mesh needs at least one device")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @classmethod
    def on(cls, device, shape, axis_names) -> "Mesh":
        """A mesh of ``shape`` whose every coordinate is ``device``."""
        arr = np.empty(tuple(shape), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(device)
        return cls(arr, axis_names)

    @property
    def size(self) -> int:
        return self.devices.size

    def coords(self):
        """Every coordinate, in row-major order."""
        return itertools.product(*(range(n) for n in self.devices.shape))

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {sorted({str(d) for d in self.devices.flat})})"

    def __enter__(self) -> "Mesh":
        _CURRENT.stack = getattr(_CURRENT, "stack", []) + [self]
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.stack = _CURRENT.stack[:-1]


_CURRENT = threading.local()


def current_mesh() -> Mesh | None:
    """The innermost mesh entered with ``with mesh:`` on this thread."""
    stack = getattr(_CURRENT, "stack", [])
    return stack[-1] if stack else None


def _visible(n_devices: int, device) -> list[torch.device]:
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    avail = visible_devices(kind)
    if n_devices > avail:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {avail} {kind} "
            f"device(s) are visible (build Mesh.on(device, shape, names) to "
            f"place several coordinates on one device)")
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [torch.device(kind)]


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Deprecated shim over :func:`make_mesh_for_devices`: the fixed 16 x 16
    (single pod) or 2 x 16 x 16 (``multi_pod``) shapes, with the device
    count checked up front."""
    warnings.warn(
        "make_production_mesh is deprecated; use "
        "make_mesh_for_devices(n_devices, model_parallel=..., pods=...)",
        DeprecationWarning, stacklevel=2)
    n = 512 if multi_pod else 256
    avail = visible_devices(torch.device(device).type)
    if n > avail:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs {n} devices "
            f"but only {avail} device(s) are visible"
            + (" — a multi-pod mesh cannot be built on a single host"
               if multi_pod else ""))
    return make_mesh_for_devices(n, model_parallel=16,
                                 pods=2 if multi_pod else 1, device=device)


def make_mesh_for_devices(n_devices: int, *, model_parallel: int = 1,
                          pods: int = 1, device="cuda") -> Mesh:
    """The largest ``(pod, data, model)`` mesh for a device count over the
    first ``n_devices`` devices of ``device``'s type (``("data",
    "model")`` when ``pods`` is 1); raises when fewer are visible."""
    if n_devices < 1 or model_parallel < 1 or pods < 1:
        raise ValueError(
            f"mesh factors must be positive: n_devices={n_devices}, "
            f"model_parallel={model_parallel}, pods={pods}")
    if n_devices % (model_parallel * pods) != 0:
        raise ValueError(
            f"n_devices={n_devices} is not divisible by "
            f"model_parallel*pods={model_parallel * pods} "
            f"(model_parallel={model_parallel}, pods={pods}); "
            f"cannot form a rectangular (pod, data, model) mesh")
    devs = _visible(n_devices, device)
    data = n_devices // (model_parallel * pods)
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    if pods > 1:
        return Mesh(arr.reshape(pods, data, model_parallel),
                    ("pod", "data", "model"))
    return Mesh(arr.reshape(data, model_parallel), ("data", "model"))
