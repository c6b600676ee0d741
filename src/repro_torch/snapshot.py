"""Snapshot files of the port: atomic writes and a restricted reader.

Calibration snapshots (:mod:`repro_torch.core.calibrate`) and plan-cache
snapshots (:class:`repro_torch.serving.cache.SharedPlanCache`) are pickles
of host values: the port's own dataclasses, numpy arrays and plain Python
values.  :func:`load` unpickles through an ``Unpickler`` whose
``find_class`` admits only the names on an explicit list: the dataclasses
a snapshot holds, numpy's array and dtype reconstructors and the plain
value types of ``builtins``.  Any other name (a dotted name, another class
of a module on the list, a class of another package — a snapshot of the
JAX package among them) is refused before its module is imported, so a
crafted file can construct nothing but those values.
"""
from __future__ import annotations

import builtins
import os
import pickle

# (module, name) of every class a snapshot of the port holds
_PORT = {
    ("repro_torch.core.calibrate", "CalibratedModel"),
    ("repro_torch.core.perfmodel", "HardwareModel"),
    ("repro_torch.core.perfmodel", "TaskShape"),
    ("repro_torch.core.partition", "Task"),
    ("repro_torch.core.partition", "KernelPartition"),
    ("repro_torch.core.partition", "DevicePlacement"),
    ("repro_torch.core.scheduler", "ScheduleReport"),
    ("repro_torch.core.plancache", "KernelPlan"),
    ("repro_torch.core.plancache", "StructureEntry"),
    ("repro_torch.core.dispatch", "DispatchGeometry"),
    ("repro_torch.core.dispatch", "CompiledDispatch"),
    ("repro_torch.core.dispatch", "ActivationGeometry"),
    ("repro_torch.core.dispatch", "ActivationDispatch"),
    ("repro_torch.core.shard_exec", "ShardedDispatch"),
    ("repro_torch.core.halo", "ColumnSupport"),
    ("repro_torch.core.halo", "HaloGeometry"),
    ("repro_torch.kernels.formats", "BlockCSR"),
    ("repro_torch.serving.cache", "GraphKey"),
}
# (module, name) of the numpy callables an array or scalar pickle names
_NUMPY = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
}
_BUILTINS = {"tuple", "list", "dict", "set", "frozenset", "int", "float",
             "complex", "bool", "str", "bytes", "bytearray", "slice",
             "range"}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "builtins" and name in _BUILTINS:
            return getattr(builtins, name)
        if (module, name) in _NUMPY or (module, name) in _PORT:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"snapshot names {module}.{name}, "
                                     "which a repro_torch snapshot never "
                                     "holds")


def load(f):
    """Unpickle one payload from the binary file ``f`` (restricted)."""
    return _Unpickler(f).load()


def atomic_dump(path: str, payload, *, before_dump=None) -> None:
    """Pickle ``payload`` to ``path`` atomically: a same-directory temp file
    moved into place with ``os.replace``, so a crash mid-save leaves the
    previous file intact and no temp file behind.  ``before_dump`` runs
    after the temp file is open (the fault-injection hook of the save
    path)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            if before_dump is not None:
                before_dump()
            pickle.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
