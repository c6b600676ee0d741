"""Sharding rules and placement over a :class:`~repro_torch.launch.mesh.Mesh`:
the reference's ``repro/distributed/sharding.py``.

Layout (MaxText-style 2-D sharding), as the reference's:

- tensor-parallel axis ``model``: attention heads, MLP hidden, vocab,
  experts;
- FSDP axis ``data`` (plus ``pod`` when present): the non-TP dimension of
  every large parameter and both AdamW moments (ZeRO-3 on top of TP);
- batch axis for activations: ``("pod", "data")``.

*Rules.*  A spec is a tuple with one entry per dimension: None, an axis
name, or a tuple of axis names (the reference's ``PartitionSpec``, which
prints a one-axis entry as the bare name; :func:`normalize` makes the two
spellings compare equal).  The rules are pure host functions of (path,
shape, ``mesh.axis_names``, ``mesh.shape``), ported line for line on the
reference's ``/``-joined pytree paths (``_param_spec_path``,
``_cache_spec_path``).  The reference stacks the layers of ``cycles``,
``enc_layers`` and ``dec_layers`` (caches: ``cycles`` and ``dec``) on a
leading axis; the port's modules are per layer with dotted names
(``cycles.0.layer0.mixer.wq``).  :func:`param_spec` / :func:`cache_spec`
take the port's name and per-layer shape, drop the stacked layer index
(an index after ``tail`` is a list item and stays), apply the reference's
rule to the stacked shape and drop the stacked axis's leading None again.

*Placement.*  :class:`Sharded` is a leaf placed by a spec on a mesh: it
holds, per mesh coordinate, the local block on that coordinate's device.
Coordinates that hold the same block on the same device share one tensor
(a replicated axis does not multiply memory on one card); the same block
on two devices is two copies.  :func:`shard` places a tensor,
:func:`unshard` gathers one.

*Activation anchors.*  :func:`constrain` is the reference's
``with_sharding_constraint`` wrapper: the identity outside a mesh; inside
one it resolves its entries exactly as the reference does
(:func:`resolve`) and returns ``x`` unchanged.  Placement of activations
is the compute layer's (``launch/steps.py``), which reads the residual
stream's anchor (:func:`residual_entries`, the entries the models'
``constrain`` states) resolved on the step's shape: rows split over the
dp axes where it keeps them, the sequence over ``model`` where it keeps
that.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch

from repro_torch.launch.mesh import Mesh, current_mesh


def _axes(mesh: Mesh, *names: str) -> tuple[str, ...]:
    return tuple(n for n in names if n in mesh.axis_names)


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    return _axes(mesh, "pod", "data")


def fsdp_axes(mesh: Mesh) -> tuple[str, ...]:
    return _axes(mesh, "pod", "data")


def _size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _guard(mesh: Mesh, spec_entries, shape) -> tuple:
    """Drop sharding on dims the mesh axes don't divide."""
    out = []
    for dim, entry in zip(shape, spec_entries):
        if entry is None or dim % _size(mesh, entry) != 0:
            out.append(None)
        else:
            out.append(entry)
    return tuple(out)


def normalize(spec) -> tuple:
    """A spec spelled as the reference's ``PartitionSpec`` prints it: a
    one-axis entry as the bare axis name (``("data",)`` as ``"data"``), an
    empty one as None."""
    return tuple((e[0] if len(e) == 1 else e or None)
                 if isinstance(e, tuple) else e for e in spec)


# (regex on the leaf name, spec rule given the unstacked shape)
def _param_rules(mesh: Mesh):
    F = fsdp_axes(mesh)
    return [
        # embeddings / unembedding
        (r"embed$", lambda s: (("model",), F)),
        (r"lm_head$", lambda s: (F, ("model",))),
        # attention & MLA projections
        (r"(wq|wk|wv)$", lambda s: (F, ("model",))),
        (r"wo$", lambda s: (("model",), F)),
        (r"(bq|bk|bv)$", lambda s: (("model",),)),
        (r"w_dkv$", lambda s: (F, None)),
        (r"w_kpe$", lambda s: (F, None)),
        (r"(w_uk|w_uv)$", lambda s: (None, ("model",))),
        # dense MLP
        (r"(w_gate|w_up)$", lambda s: (F, ("model",)) if len(s) == 2 else None),
        (r"w_down$", lambda s: (("model",), F) if len(s) == 2 else None),
        # MoE: experts axis = EP over model
        (r"router$", lambda s: (F, None)),
        (r"experts?.*|.*moe.*", lambda s: None),  # placeholder, as the reference
        # RG-LRU
        (r"(w_in|w_gate)$", lambda s: (F, ("model",))),
        (r"w_out$", lambda s: (("model",), F)),
        (r"conv_w$", lambda s: (None, ("model",))),
        (r"(w_rgate|b_rgate|w_igate|b_igate|lam|conv_b)$",
         lambda s: (("model",),)),
        # SSD extras
        (r"(a_log|dt_bias|d_skip)$", lambda s: (None,)),
        (r"(out_norm|kv_norm)$", lambda s: (None,)),
    ]


def _moe_spec(name: str, shape, mesh: Mesh):
    """Expert-stacked tensors [E, D, F] / [E, F, D]: EP over model."""
    F = fsdp_axes(mesh)
    if name.endswith(("w_gate", "w_up")):
        return (("model",), F, None)
    if name.endswith("w_down"):
        return (("model",), None, F)
    return None


def _param_spec_path(path: str, shape, mesh: Mesh) -> tuple:
    """The reference's ``param_spec`` on its ``/``-path and stacked
    shape."""
    n_stack = len(re.findall(r"(cycles|enc_layers|dec_layers)", path))
    core_shape = shape[n_stack:]
    name = path.split("/")[-1]

    spec = None
    if "/shared/" in path or path.endswith("shared"):
        # shared experts = dense MLP rules
        if name in ("w_gate", "w_up"):
            spec = (fsdp_axes(mesh), ("model",))
        elif name == "w_down":
            spec = (("model",), fsdp_axes(mesh))
    elif len(core_shape) == 3:
        spec = _moe_spec(name, core_shape, mesh)
    if spec is None:
        for pat, rule in _param_rules(mesh):
            if re.search(pat, name):
                spec = rule(core_shape)
                break
    if spec is None:
        # default: replicate small leaves, FSDP large matrices
        if len(core_shape) == 2 and core_shape[0] * core_shape[1] > 1 << 20:
            spec = (fsdp_axes(mesh), None)
        else:
            spec = (None,) * len(core_shape)
    if spec is not None and len(spec) != len(core_shape):
        spec = (None,) * len(core_shape)
    full = (None,) * n_stack + tuple(spec)
    return _guard(mesh, full, shape)


def _cache_spec_path(path: str, shape, mesh: Mesh) -> tuple:
    """The reference's ``cache_spec`` on its ``/``-path and stacked
    shape: batch over the dp axes, heads (or length) over model."""
    dp = dp_axes(mesh)
    n_stack = 1 if "cycles" in path or "dec" in path.split("/")[0] else 0
    core = shape[n_stack:]
    name = path.split("/")[-1]
    if name in ("k", "v", "cross_k", "cross_v"):      # [B, L, Hkv, Dh]
        # length over model: KV-head counts (8, 2, 1) don't divide a
        # 16-way TP axis, but a 32k cache length does
        spec = (dp, ("model",), None, None)
    elif name in ("kv_c", "kpe"):                     # [B, L, R]
        spec = (dp, None, None)
    elif name == "state":                             # [B, H, P, N]
        spec = (dp, ("model",), None, None)
    elif name == "conv":                              # [B, W-1, C]
        spec = (dp, None, ("model",))
    elif name == "h":                                 # [B, dr]
        spec = (dp, ("model",))
    else:
        spec = (None,) * len(core)
    full = (None,) * n_stack + tuple(spec)
    return _guard(mesh, full, shape)


# the reference's stacked layer lists, for parameters and for caches
PARAM_STACKS = ("cycles", "enc_layers", "dec_layers")
CACHE_STACKS = ("cycles", "dec")


def reference_path(name: str, stacks=PARAM_STACKS) -> tuple[str, int]:
    """The reference's ``/``-path of the port's dotted ``name``, and how
    many stacked layer indices were dropped from it (``cycles.0.layer0.wq``
    -> ``("cycles/layer0/wq", 1)``; ``tail.1.wq`` -> ``("tail/1/wq",
    0)``)."""
    parts = name.split(".")
    out, dropped = [], 0
    for i, part in enumerate(parts):
        if part.isdigit() and i and parts[i - 1] in stacks:
            dropped += 1
            continue
        out.append(part)
    return "/".join(out), dropped


def _unstacked(rule, name: str, shape, mesh: Mesh, stacks) -> tuple:
    path, n = reference_path(name, stacks)
    spec = rule(path, (1,) * n + tuple(shape), mesh)
    if any(e is not None for e in spec[:n]):
        raise AssertionError(f"{name}: stacked axis sharded in {spec}")
    return spec[n:]


def param_spec(name: str, shape, mesh: Mesh) -> tuple:
    """The spec of the parameter ``name`` (the port's dotted name, its
    per-layer shape)."""
    return _unstacked(_param_spec_path, name, shape, mesh, PARAM_STACKS)


def cache_spec(name: str, shape, mesh: Mesh) -> tuple:
    """The spec of the decode-cache leaf ``name`` (the dotted path of the
    port's cache tree, e.g. ``cycles.0.layer0.k`` or ``dec.1.self.k``)."""
    return _unstacked(_cache_spec_path, name, shape, mesh, CACHE_STACKS)


def batch_spec(path: str, shape, mesh: Mesh) -> tuple:
    """Batch leaves: rows over the dp axes when they divide."""
    dp = dp_axes(mesh)
    if len(shape) == 0:
        return ()
    spec = (dp,) + (None,) * (len(shape) - 1)
    return _guard(mesh, spec, shape)


def params_shardings(params, mesh: Mesh, *,
                     fsdp: bool = True) -> dict[str, tuple]:
    """``{parameter name: spec}`` of a model's parameters (``params``: the
    module, or a dict of name -> tensor or sharded leaf).  ``fsdp=False``
    is the TP-only layout (replicated over data / pod, sharded over
    model): the reference's inference layout."""
    named = (params.named_parameters()
             if isinstance(params, torch.nn.Module) else params.items())
    specs = {n: param_spec(n, tuple(p.shape), mesh) for n, p in named}
    if fsdp:
        return specs
    dp = set(dp_axes(mesh))

    def tp_only(spec):
        entries = []
        for e in spec:
            es = (e,) if isinstance(e, str) else (e or ())
            keep = tuple(a for a in es if a not in dp)
            entries.append(keep if keep else None)
        return tuple(entries)

    return {n: tp_only(s) for n, s in specs.items()}


def _tree_specs(tree, mesh: Mesh, spec_fn, prefix: str = "") -> dict:
    """``{dotted path: spec}`` of every tensor of a nested dict / list."""
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: spec_fn(prefix[:-1], tuple(tree.shape), mesh)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items
            for k, v in _tree_specs(sub, mesh, spec_fn,
                                    f"{prefix}{key}.").items()}


def cache_shardings(cache, mesh: Mesh) -> dict[str, tuple]:
    """``{dotted path: spec}`` of every leaf of a decode cache."""
    return _tree_specs(cache, mesh, cache_spec)


def batch_shardings(batch, mesh: Mesh) -> dict[str, tuple]:
    """``{name: spec}`` of every tensor of a batch."""
    return _tree_specs(batch, mesh, batch_spec)


# ------------------------------------------------------------ placement
def block_index(spec, mesh: Mesh, coord) -> tuple[int, ...]:
    """Which block of each dimension mesh coordinate ``coord`` holds: the
    row-major index of its coordinates over the dimension's axes."""
    pos = dict(zip(mesh.axis_names, coord))
    out = []
    for entry in spec:
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + pos[a]
        out.append(i)
    return tuple(out)


def block_shape(spec, shape, mesh: Mesh) -> tuple[int, ...]:
    """The local shape of a leaf of ``shape`` placed by ``spec``."""
    return tuple(d // _size(mesh, e) for d, e in zip(shape, spec))


def _slices(spec, shape, mesh: Mesh, block) -> tuple[slice, ...]:
    local = block_shape(spec, shape, mesh)
    return tuple(slice(b * n, (b + 1) * n) for b, n in zip(block, local))


@dataclasses.dataclass
class Sharded:
    """A leaf of global ``shape`` placed by ``spec`` on ``mesh``:
    ``tensors[(block, device)]`` is the block on that device, and
    ``where[coord]`` names the ``(block, device)`` of each coordinate."""
    mesh: Mesh
    spec: tuple
    shape: tuple[int, ...]
    dtype: torch.dtype
    tensors: dict
    where: dict

    def local(self, coord) -> torch.Tensor:
        """The tensor mesh coordinate ``coord`` holds."""
        return self.tensors[self.where[tuple(coord)]]

    def slices(self, block) -> tuple[slice, ...]:
        """Where ``block`` lies in the global tensor."""
        return _slices(self.spec, self.shape, self.mesh, block)

    @property
    def block_shape(self) -> tuple[int, ...]:
        """The shape of every block."""
        return block_shape(self.spec, self.shape, self.mesh)

    @property
    def device(self) -> torch.device:
        """The device of the mesh's first coordinate."""
        return self.mesh.devices.flat[0]

    def nbytes(self, coord) -> int:
        t = self.local(coord)
        return t.numel() * t.element_size()


def _placed(spec, shape, dtype, mesh: Mesh, make) -> Sharded:
    spec = tuple(spec)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a leaf of shape {tuple(shape)}")
    for dim, e in zip(shape, spec):
        if dim % _size(mesh, e):
            raise ValueError(f"spec {spec} does not divide shape "
                             f"{tuple(shape)} on {mesh}")
    tensors, where = {}, {}
    for coord in mesh.coords():
        key = (block_index(spec, mesh, coord), mesh.device(coord))
        if key not in tensors:
            tensors[key] = make(*key)
        where[coord] = key
    return Sharded(mesh, spec, tuple(shape), dtype, tensors, where)


def shard(t: torch.Tensor, spec, mesh: Mesh) -> Sharded:
    """``t`` placed by ``spec`` on ``mesh``: each block copied to each
    device that holds it (a copy also where the device is ``t``'s)."""
    t = t.detach()
    sl = lambda block: _slices(spec, t.shape, mesh, block)   # noqa: E731
    return _placed(spec, tuple(t.shape), t.dtype, mesh,
                   lambda block, dev: t[sl(block)].to(
                       device=dev, memory_format=torch.contiguous_format,
                       copy=True))


def _shard_tree(tree, specs: dict, mesh: Mesh, prefix: str = ""):
    """A nested dict / list of tensors with each leaf placed by
    ``specs[dotted path]`` (:func:`shard`): the same tree of
    ``Sharded`` leaves."""
    if isinstance(tree, torch.Tensor):
        return shard(tree, specs[prefix[:-1]], mesh)
    if isinstance(tree, dict):
        return {k: _shard_tree(v, specs, mesh, f"{prefix}{k}.")
                for k, v in tree.items()}
    return [_shard_tree(v, specs, mesh, f"{prefix}{i}.")
            for i, v in enumerate(tree)]


def shard_cache(cache, mesh: Mesh):
    """A decode cache placed by :func:`cache_shardings` (the reference's
    ``cache_shardings`` in a serve step's ``in_shardings``): the cache's
    tree of ``Sharded`` leaves, what ``make_serve_step(bundle, mesh)``
    takes."""
    return _shard_tree(cache, cache_shardings(cache, mesh), mesh)


def tree_leaves(tree, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of a nested dict / list whose leaves are
    tensors or ``Sharded``."""
    if isinstance(tree, (torch.Tensor, Sharded)):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items
            for k, v in tree_leaves(sub, f"{prefix}{key}.").items()}


def zeros_like(leaf: Sharded, dtype=None) -> Sharded:
    """Zeros placed as ``leaf`` is (in ``dtype``, default its own)."""
    dtype = dtype or leaf.dtype
    return _placed(leaf.spec, leaf.shape, dtype, leaf.mesh,
                   lambda block, dev: torch.zeros(leaf.block_shape,
                                                  dtype=dtype, device=dev))


@torch.no_grad()
def fill(leaf: Sharded, t: torch.Tensor) -> None:
    """Write the global tensor ``t`` into ``leaf``'s blocks, in place."""
    if tuple(t.shape) != leaf.shape:
        raise ValueError(f"shape {tuple(t.shape)} for a leaf of "
                         f"{leaf.shape}")
    for (block, _), dst in leaf.tensors.items():
        dst.copy_(t[leaf.slices(block)])


@torch.no_grad()
def gather_into(leaf: Sharded, out: torch.Tensor) -> torch.Tensor:
    """Write every block of ``leaf`` into its place in ``out``."""
    done = set()
    for (block, _), t in leaf.tensors.items():
        if block not in done:
            out[leaf.slices(block)].copy_(t)
            done.add(block)
    return out


@torch.no_grad()
def gather_region(leaf: Sharded, where, out: torch.Tensor) -> torch.Tensor:
    """Write the part of ``leaf`` inside ``where`` (a slice with bounds
    for each dimension) into ``out``, from every block it overlaps."""
    done = set()
    for (block, _), t in leaf.tensors.items():
        if block in done:
            continue
        done.add(block)
        src, dst = [], []
        for s, w in zip(leaf.slices(block), where):
            lo, hi = max(s.start, w.start), min(s.stop, w.stop)
            if lo >= hi:
                break
            src.append(slice(lo - s.start, hi - s.start))
            dst.append(slice(lo - w.start, hi - w.start))
        else:
            out[tuple(dst)].copy_(t[tuple(src)])
    return out


def unshard(leaf: Sharded, device) -> torch.Tensor:
    """The global tensor of ``leaf`` on ``device``."""
    return gather_into(leaf, torch.empty(leaf.shape, dtype=leaf.dtype,
                                         device=device))


# ------------------------------------------------------- activation anchors
def resolve(shape, entries, mesh: Mesh) -> tuple:
    """The reference's resolution of ``constrain``'s logical entries on
    ``mesh``: "dp" becomes the batch axes (None without them), an axis the
    mesh lacks becomes None, and so does an entry whose size does not
    divide its dimension."""
    resolved = []
    for dim, e in zip(shape, entries):
        if e == "dp":
            e = dp_axes(mesh) or None
        elif isinstance(e, str) and e not in mesh.axis_names:
            e = None
        if e is not None and dim % _size(mesh, e) != 0:
            e = None
        resolved.append(e)
    return tuple(resolved)


def residual_entries(seq_shard: bool) -> tuple:
    """The reference's anchor of the residual stream [rows, L, D] at each
    cycle (``repro/models/lm.py``): the batch over dp, and with
    ``seq_shard`` the sequence over ``model`` (Megatron-style)."""
    return ("dp", "model" if seq_shard else None, None)


def constrain(x: torch.Tensor, *entries) -> torch.Tensor:
    """``x``, unchanged: the reference's anchor.  Inside a mesh (``with
    mesh:``) its entries are resolved as the reference resolves them
    (:func:`resolve`); outside one nothing is done."""
    mesh = current_mesh()
    if mesh is not None:
        resolve(x.shape, entries, mesh)
    return x
