"""Fault-tolerant checkpointing, async and atomic: the reference's
``repro/checkpoint/manager.py`` for the port's state.

Layout per step::

    <dir>/step_000000123.tmp/   (written)
    <dir>/step_000000123/       (atomic rename on completion)
        manifest.json           step, config hash, every leaf's path,
                                shape and dtype
        arr_<idx>.npy           one file per leaf

- *Leaves*: a state is a nested dict (or list) whose leaves are tensors;
  an ``nn.Module`` in it stands for its parameters.  Each leaf is named
  by its dotted path: ``params.<parameter name>`` for the model,
  ``opt.mu.*``, ``opt.nu.*``, ``opt.step``, and ``ef.*`` when present.
  bfloat16 leaves (numpy has no bfloat16) are stored as their int16 bit
  patterns with the manifest's dtype ``bfloat16``, so every leaf comes
  back bitwise.
- *Atomicity*: rename on completion; a crashed writer leaves only
  ``.tmp``, which restore ignores and the next save removes.
- *Async*: ``save`` copies every leaf to host memory before it returns (a
  copy even for a CPU tensor, so the in-place optimizer step that follows
  cannot reach the snapshot) and hands the file I/O to a background
  thread; ``wait`` joins it (one outstanding snapshot) and raises what the
  writer raised.
- *Sharded leaves* (a state placed on a mesh, ``launch/steps.py``): a
  :class:`~repro_torch.distributed.sharding.Sharded` leaf is gathered to
  the host whole, so its files and manifest are exactly what a
  single-device save writes and either kind of checkpoint restores into
  either kind of state.
- *Restore* writes the checkpoint into a template state's own tensors
  (the objects the model and the optimizer hold; a sharded leaf's
  blocks), on each leaf's device or on ``device``.  With ``shardings``
  (the reference's resharding path) it returns a new state instead, each
  leaf placed by the caller's spec on the current mesh (``with mesh:``):
  a tree of specs matched to the template by name, where a None subtree
  means unsharded on the template leaf's device.
- *Retention*: the last ``keep`` checkpoints are kept.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.launch.mesh import current_mesh


def state_leaves(state: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(dotted path, tensor or sharded leaf) of every leaf of ``state``, in
    its order."""
    if isinstance(state, (torch.Tensor, sharding.Sharded)):
        return [(prefix[:-1], state)]
    if isinstance(state, nn.Module):
        return [(prefix + n, p) for n, p in state.named_parameters()]
    if isinstance(state, dict):
        items = state.items()
    elif isinstance(state, (list, tuple)):
        items = enumerate(state)
    else:
        raise TypeError(f"{prefix[:-1] or 'state'}: {type(state).__name__} "
                        "is not a tensor, module, dict or list")
    return [leaf for k, v in items
            for leaf in state_leaves(v, f"{prefix}{k}.")]


def config_hash(cfg: Any) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def _to_host(t) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (a sharded leaf gathered whole) as numpy, and
    its dtype's name."""
    t = (sharding.unshard(t, "cpu") if isinstance(t, sharding.Sharded)
         else t.detach())
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy(), name


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 cfg: Any = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.cfg_hash = config_hash(cfg) if cfg is not None else None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        self.wait()  # one outstanding snapshot
        # snapshot to host BEFORE returning control (a consistent cut)
        host = [(path, *_to_host(t)) for path, t in state_leaves(state)]
        manifest = {
            "step": step,
            "time": time.time(),
            "config_hash": self.cfg_hash,
            "leaves": [{"path": p, "shape": list(a.shape), "dtype": dt}
                       for p, a, dt in host],
        }

        def write():
            tmp = self.dir / f"step_{step:09d}.tmp"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, (_, a, _) in enumerate(host):
                np.save(tmp / f"arr_{i}.npy", a)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:   # handed to wait(), which raises
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the outstanding write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
        for tmp in self.dir.glob("*.tmp"):
            shutil.rmtree(tmp, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, *, step: int | None = None,
                device=None, shardings: Any = None) -> tuple[int, Any]:
        """Checkpoint ``step`` (default: the latest) for the template's
        leaves, matched by name; returns ``(step, state)``.  Without
        ``shardings`` every leaf is written into the template, in place
        (each on its own device or on ``device``; a sharded leaf block by
        block) and ``state`` is the template.  With ``shardings`` (a tree
        of specs, a prefix of the template's: a spec tuple places the
        subtree's leaves by it on the current mesh, None leaves them
        unsharded on the template leaf's device) ``state`` is a new tree
        of dicts and lists holding the placed leaves."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        if (self.cfg_hash and manifest["config_hash"]
                and manifest["config_hash"] != self.cfg_hash):
            raise ValueError(
                f"checkpoint config hash {manifest['config_hash']} != "
                f"current {self.cfg_hash}")
        leaves = state_leaves(state_template)
        have = {l["path"]: (i, l) for i, l in enumerate(manifest["leaves"])}
        missing = [p for p, _ in leaves if p not in have]
        if missing:
            raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
        for path, t in leaves:
            shape = tuple(have[path][1]["shape"])
            if shape != tuple(t.shape):
                raise ValueError(f"{path}: shape {shape} != "
                                 f"template {tuple(t.shape)}")

        def load(path):         # one leaf at a time: host memory of one
            i, leaf = have[path]
            return _from_host(np.load(d / f"arr_{i}.npy"), leaf["dtype"])

        if shardings is not None:
            return step, _placed(state_template, shardings, load, "")
        for path, t in leaves:
            arr = load(path)
            if isinstance(t, sharding.Sharded):
                sharding.fill(t, arr.to(t.dtype))
            else:
                t.data = arr.to(device if device is not None else t.device,
                                t.dtype)
        return step, state_template


def _placed(template: Any, spec: Any, load, prefix: str) -> Any:
    """A new tree shaped as ``template`` (a module stands for its
    parameters, as a dict of them) with each leaf's array (``load(path)``)
    placed by ``spec``, the matching part of the caller's spec tree
    (matched by key)."""
    if isinstance(template, (torch.Tensor, sharding.Sharded)):
        arr = load(prefix[:-1]).to(template.dtype)
        if spec is None:
            return arr.to(template.device)
        mesh = current_mesh()
        if mesh is None:
            raise ValueError(f"{prefix[:-1]}: a spec to place by but no "
                             "current mesh (restore inside `with mesh:`)")
        return sharding.shard(arr, spec, mesh)
    if isinstance(template, nn.Module):
        template = dict(template.named_parameters())
    if isinstance(template, dict):
        items = template.items()
    elif isinstance(template, (list, tuple)):
        items = enumerate(template)
    else:
        raise TypeError(f"{prefix[:-1] or 'state'}: "
                        f"{type(template).__name__} is not a tensor, "
                        "module, dict or list")

    def sub(key):
        if spec is None or isinstance(spec, tuple):
            return spec                     # a spec or None: broadcast
        try:
            return spec[key]
        except (KeyError, IndexError):
            raise ValueError(f"shardings has no entry for "
                             f"{prefix}{key}") from None

    out = {k: _placed(v, sub(k), load, f"{prefix}{k}.") for k, v in items}
    return out if isinstance(template, dict) else list(out.values())
