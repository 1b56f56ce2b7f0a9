"""Sharding rules: parameter, optimiser, batch and cache placements on a
``DeviceMesh`` (counterpart of ``repro.launch.sharding``).

Strategy, the reference's: 2-D FSDP x TP --

  * weights: tensor-parallel on "model" (output dim for up-projections,
    input dim for down-projections, expert axis for MoE when divisible),
    plus FSDP on "data" over the first other divisible dim;
  * activations / caches: batch on ("pod", "data"); KV heads on "model"
    when the head count divides, else replicated (MQA);
  * everything falls back to replication when sizes do not divide: the
    rules are pure shape arithmetic.

A rule yields a *spec*, the reference's ``PartitionSpec`` as a tuple
(one entry a tensor dim: ``None``, an axis name, or a tuple of axis
names), and ``placements`` turns a spec into DTensor placements, one per
mesh dim (``Shard(d)`` on each mesh dim named at tensor dim ``d``, in
mesh order, which is the reference's major-to-minor order of a tuple
entry).  A mesh is a ``DeviceMesh`` or a ``MeshShape`` stand-in (names
and sizes, no process group), which is all the rules read.

**The reference's tree walk.**  ``tree_pspecs`` builds each leaf's path
as the reference's does, every key followed by "/", so the path of
``layers/attn/wq/w`` reaches ``param_pspec`` as ``layers/attn/wq/w/``:
its last part is empty, so the name classes (column, row, vocab) never
match and only the expert-parallel and FSDP rules apply.  The port keeps
that walk, so that its placements equal the reference's leaf for leaf;
``param_pspec`` called with a path without the trailing "/" applies the
tensor-parallel classes, as the reference's does.

**Per-layer tensors.**  The rules read the reference's *stacked* leaves
(``repro_torch.weights.jax_path`` / ``stack_tree``: ``layers/attn/wq/w``
is ``(n_layers, d_in, d_out)``), but the port keeps one tensor a layer.
The rule may put an axis (in practice "data", FSDP's) on a stacked axis
-- e.g. llama3.2-1b's 16 layers over a "data" axis of 16 -- which says
"device row i holds layer i whole".  A DTensor is on every device of its
mesh, so ``layer_spec`` moves each axis found on a stacked axis onto the
per-layer tensor: onto its first dim that the axis divides on top of
what already shards that dim (the dim itself if it is free).  Each
device then holds 1/n of every layer instead of n/L whole layers: its
parameter bytes are the reference spec's whenever such a dim exists,
which ``tests/test_torch_sharding.py`` checks for every arch.  Where no
dim divides, the axis is dropped (replicated) and the bytes grow; the
test names any such leaf.  The optimiser's moments keep the stacked
layout (``optim.adamw``) and take the *moved* spec with the stacked
axes left whole (``stacked_spec``), so that the update's per-layer view
into a moment is a local view with the parameter's own placements.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.shapes import TensorSpec
from repro_torch.models.common import ModelConfig
from repro_torch.weights import jax_path

#: one tensor dim's entry: None, an axis name, or a tuple of axis names
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# parameter-name classes: which dim gets the "model" axis
_COL_PARALLEL = ("wq", "wk", "wv", "gate", "up", "k_up", "v_up", "w_in",
                 "w_gate", "lru_a", "lru_x", "in_proj", "wq_b")
_ROW_PARALLEL = ("wo", "down", "out_proj", "w_out")
_VOCAB_PARALLEL = ("table", "unembed")


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices or a process group:
    enough for the rules (``MeshShape(("data", "model"), (16, 16))``)."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, name: str) -> int:
    return _sizes(mesh).get(name, 1)


def _names(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _join(names: Sequence[str], mesh) -> Entry:
    """Axis names as one spec entry, in mesh order."""
    order = list(mesh.mesh_dim_names)
    names = sorted(names, key=order.index)
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def placements(spec: Spec, mesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec``: one a mesh dim, ``Shard(d)`` where
    the spec names that axis at tensor dim ``d``, else ``Replicate()``."""
    out: list = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for name in _names(entry):
            out[list(mesh.mesh_dim_names).index(name)] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The largest shard of a tensor of ``shape`` under ``spec`` (rank
    0's: DTensor gives the first ranks the ceil-divided chunks)."""
    sizes = _sizes(mesh)
    out = []
    for s, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        for name in _names(entry):
            s = -(-s // sizes[name])
        out.append(s)
    return tuple(out)


def spec_bytes(shape: Sequence[int], itemsize: int, spec: Spec,
               mesh) -> int:
    """Bytes one device holds of a tensor of ``shape`` under ``spec``."""
    return math.prod(local_shape(shape, spec, mesh)) * itemsize


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
def _fsdp_extend(spec: list, shape: Tuple[int, ...], mesh, skip: set) -> list:
    """Add a "data" (FSDP) axis on the first divisible unsharded dim."""
    d = _axis_size(mesh, "data")
    if d == 1:
        return spec
    for i, s in enumerate(shape):
        if i in skip or spec[i] is not None:
            continue
        if s % d == 0 and s >= d:
            spec[i] = "data"
            return spec
    return spec


def _itemsize(leaf) -> int:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return 4
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return getattr(dtype, "itemsize", 4)


def param_spec(path: str, leaf, mesh, cfg: ModelConfig, fsdp: bool = True,
               fsdp_min_bytes: int = 0) -> Spec:
    """The reference's spec of one parameter leaf (``leaf`` has a
    ``shape`` and a ``dtype``), from its "/"-joined key path and its
    stacked shape.

    ``fsdp=False`` keeps weights TP-only (replicated over "data"), the
    choice for serving, where there is no optimiser state;
    ``fsdp_min_bytes`` leaves smaller leaves replicated."""
    shape = tuple(leaf.shape)
    m = _axis_size(mesh, "model")
    spec: list = [None] * len(shape)
    parts = path.split("/")
    name = parts[-2] if parts[-1] in ("w", "b") else parts[-1]
    is_bias = parts[-1] == "b"
    is_expert = "experts" in parts

    if len(shape) == 0:
        return ()
    if name in _VOCAB_PARALLEL or (name == "unembed" and not is_bias):
        # embed table (V, d) / unembed w (d, V): shard the vocab dim
        vdim = 0 if name == "table" else len(shape) - 1
        if shape[vdim] % m == 0:
            spec[vdim] = "model"
    elif is_expert and cfg.n_experts and cfg.n_experts % m == 0:
        # expert-parallel: the expert axis (first non-layer dim)
        edim = 1 if len(shape) >= 3 else 0  # (L, E, ...) stacked
        if shape[edim] == cfg.n_experts:
            spec[edim] = "model"
    elif name in _COL_PARALLEL:
        d = len(shape) - 1
        if shape[d] % m == 0 and shape[d] >= m:
            spec[d] = "model"
    elif name in _ROW_PARALLEL and not is_bias:
        d = len(shape) - 2
        if d >= 0 and shape[d] % m == 0 and shape[d] >= m:
            spec[d] = "model"
    # FSDP over "data" on another dim (weights >= 2D only; keep scalars /
    # norms replicated)
    nbytes = math.prod(shape) * _itemsize(leaf)
    if len(shape) >= 2 and fsdp and nbytes >= fsdp_min_bytes:
        spec = _fsdp_extend(spec, shape, mesh, skip=set())
    return tuple(spec)


def param_pspec(path: str, leaf, mesh, cfg: ModelConfig, fsdp: bool = True,
                fsdp_min_bytes: int = 0) -> Tuple[Placement, ...]:
    """``param_spec`` as DTensor placements."""
    return placements(param_spec(path, leaf, mesh, cfg, fsdp,
                                 fsdp_min_bytes), mesh)


def _walk(node, path: str, fn: Callable[[str, Any], Any]):
    """Map ``fn(path, leaf)`` over nested dicts, NamedTuples, lists and
    tuples, the path built as the reference's (each key then "/").
    Anything with a shape and a dtype (a tensor, a ``TensorSpec``) is a
    leaf."""
    if hasattr(node, "shape") and hasattr(node, "dtype"):
        return fn(path, node)
    if isinstance(node, dict):
        return {k: _walk(v, f"{path}{k}/", fn) for k, v in node.items()}
    if hasattr(node, "_fields"):
        return type(node)(*(_walk(getattr(node, f), f"{path}{f}/", fn)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, f"{path}{i}/", fn)
                          for i, v in enumerate(node))
    return fn(path, node)


def tree_pspecs(tree, mesh, cfg: ModelConfig, prefix: str = "",
                fsdp: bool = True, fsdp_min_bytes: int = 0):
    """``param_pspec`` over a tree of leaves (tensors or ``TensorSpec``s)
    in the reference's layout (``weights.stack_tree``, an ``AdamWState``):
    the reference's ``tree_pspecs``."""
    return _walk(tree, prefix, lambda path, leaf: (
        placements((), mesh) if not hasattr(leaf, "shape") else
        param_pspec(path, leaf, mesh, cfg, fsdp, fsdp_min_bytes)))


# ---------------------------------------------------------------------------
# the per-layer layout
# ---------------------------------------------------------------------------
def stacked_spec(spec: Spec, shape: Sequence[int], n_stacked: int,
                 mesh) -> Spec:
    """``spec`` of a stacked leaf of ``shape`` (its first ``n_stacked``
    dims the stacked axes) with every axis on a stacked dim moved onto
    the first later dim it divides, on top of that dim's axes; an axis no
    dim takes is dropped.  The stacked dims come out whole."""
    sizes = _sizes(mesh)
    spec = list(spec) + [None] * (len(shape) - len(spec))
    moved = [n for e in spec[:n_stacked] for n in _names(e)]
    out: list = [None] * n_stacked + [_names(e) for e in spec[n_stacked:]]
    for name in moved:
        for d in range(n_stacked, len(shape)):
            have = math.prod(sizes[a] for a in out[d])
            if shape[d] % (have * sizes[name]) == 0 \
                    and shape[d] >= have * sizes[name]:
                out[d] = out[d] + (name,)
                break
    return tuple(None if d < n_stacked else _join(out[d], mesh)
                 for d in range(len(shape)))


def layer_spec(spec: Spec, shape: Sequence[int], n_stacked: int,
               mesh) -> Spec:
    """The spec of one per-layer tensor of a stacked leaf: ``stacked_spec``
    without the stacked dims."""
    return stacked_spec(spec, shape, n_stacked, mesh)[n_stacked:]


def _stacked_shapes(params: nn.Module):
    """{key path: (stacked shape, number of stacked axes, dtype)} of the
    model's parameters (``weights.stack_tree``'s leaves, by shape)."""
    groups: Dict[Tuple[str, ...], list] = {}
    for name, t in params.named_parameters():
        path, index = jax_path(name)
        groups.setdefault(path, []).append((index, t))
    out = {}
    for path, items in groups.items():
        k = len(items[0][0])
        counts = [max(i[j] for i, _ in items) + 1 for j in range(k)]
        t = items[0][1]
        out[path] = (tuple(counts) + tuple(t.shape), k, t.dtype)
    return out


def stacked_template(params: nn.Module) -> Dict[str, Any]:
    """The reference's parameter tree (nested dicts) of the model's
    parameters as ``TensorSpec`` records: each leaf's
    stacked shape, without stacking anything (the counterpart of
    ``jax.eval_shape(model.init, ...)``)."""
    tree: Dict[str, Any] = {}
    for path, (shape, _, dtype) in _stacked_shapes(params).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = TensorSpec(shape, dtype)
    return tree


def param_specs(params: nn.Module, mesh, cfg: ModelConfig,
                fsdp: bool = True, fsdp_min_bytes: int = 0
                ) -> Dict[str, Spec]:
    """{parameter name: spec} of the port's per-layer parameters: the
    reference's spec of each stacked leaf (``tree_pspecs``' walk), mapped
    onto one layer's tensor by ``layer_spec``."""
    leaves = _stacked_shapes(params)
    out = {}
    for name, _ in params.named_parameters():
        path, _ = jax_path(name)
        shape, k, dtype = leaves[path]
        spec = param_spec("/".join(path) + "/", TensorSpec(shape, dtype), mesh,
                          cfg, fsdp, fsdp_min_bytes)
        out[name] = layer_spec(spec, shape, k, mesh)
    return out


def opt_state_specs(opt_state, params: nn.Module, mesh, cfg: ModelConfig,
                    fsdp: bool = True, fsdp_min_bytes: int = 0):
    """Specs of an ``AdamWState`` (stacked moments): the reference's
    ``tree_pspecs`` of the state, each moment's spec moved off its
    stacked axes (``stacked_spec``), so that a layer's view into it has
    its parameter's placements."""
    stacked = {path: k for path, (_, k, _) in _stacked_shapes(params).items()}

    def one(path: str, leaf):
        if not hasattr(leaf, "shape"):
            return ()
        spec = param_spec(path, leaf, mesh, cfg, fsdp, fsdp_min_bytes)
        parts = tuple(p for p in path.split("/") if p)
        k = stacked.get(parts[1:], 0)  # parts[0]: "mu" / "nu" / "step"
        return stacked_spec(spec, leaf.shape, k, mesh)

    return _walk(opt_state, "", one)


# ---------------------------------------------------------------------------
# batch / activation / cache rules
# ---------------------------------------------------------------------------
def _use_dp(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    dp = [a for a in ("pod", "data") if a in mesh.mesh_dim_names]
    dp_size = math.prod(_axis_size(mesh, a) for a in dp)
    if global_batch % max(dp_size, 1) == 0 and dp_size > 1:
        return tuple(dp)
    return None


def batch_spec(batch_template: Dict[str, Any], mesh,
               global_batch: int) -> Dict[str, Spec]:
    """Shard the leading batch dim over ("pod", "data") when divisible."""
    use_dp = _use_dp(mesh, global_batch)
    out = {}
    for k, v in batch_template.items():
        nd = len(v.shape)
        if nd == 0:
            out[k] = ()
        elif use_dp is None:
            out[k] = (None,) * nd
        else:
            out[k] = (use_dp,) + (None,) * (nd - 1)
    return out


def batch_pspec(batch_template: Dict[str, Any], mesh,
                global_batch: int) -> Dict[str, Tuple[Placement, ...]]:
    """``batch_spec`` as DTensor placements."""
    return {k: placements(s, mesh)
            for k, s in batch_spec(batch_template, mesh,
                                   global_batch).items()}


def _cache_leaf_spec(mesh, cfg: ModelConfig, global_batch: int):
    m = _axis_size(mesh, "model")
    use_dp = _use_dp(mesh, global_batch)

    def leaf_spec(leaf) -> Spec:
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        batch_done = False
        for i, s in enumerate(shape):
            if not batch_done and s == global_batch and use_dp is not None:
                spec[i] = use_dp
                batch_done = True
            elif (s == cfg.n_kv_heads and cfg.n_kv_heads % m == 0
                  and cfg.n_kv_heads >= m and i >= len(shape) - 2):
                spec[i] = "model"
        return tuple(spec)

    return leaf_spec


def cache_spec(cache_template, mesh, cfg: ModelConfig, global_batch: int):
    """Specs of a serving cache (``KVCache``, ``MLACache``,
    ``MambaCache``, ``RGCache``, ``MoECache``, ``EncDecCache``).
    Heuristic per leaf: shard the first dim equal to the batch size over
    the dp axes; shard a dim equal to n_kv_heads over "model" if it
    divides.  A leaf without a shape (``write_idx``) gets ``()``."""
    leaf_spec = _cache_leaf_spec(mesh, cfg, global_batch)
    return _walk(cache_template, "", lambda _p, leaf: (
        leaf_spec(leaf) if hasattr(leaf, "shape") else ()))


def cache_pspec(cache_template, mesh, cfg: ModelConfig, global_batch: int):
    """``cache_spec`` as DTensor placements (``None`` for a leaf without
    a shape)."""
    leaf_spec = _cache_leaf_spec(mesh, cfg, global_batch)
    return _walk(cache_template, "", lambda _p, leaf: (
        placements(leaf_spec(leaf), mesh) if hasattr(leaf, "shape")
        else None))


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------
def place(t: torch.Tensor, spec: Spec, mesh) -> DTensor:
    """The full tensor ``t`` (the same on every rank) as a DTensor of
    ``spec``: each rank keeps its own chunk, no communication.  A DTensor
    ``t`` is redistributed to ``spec`` instead."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements(spec, mesh))
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def from_local(local: torch.Tensor, shape: Sequence[int], spec: Spec,
               mesh) -> DTensor:
    """A DTensor of global ``shape`` under ``spec`` whose local shard is
    ``local`` as it is (its rank's chunk, made by the caller)."""
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def named(tree, specs, mesh):
    """Place every tensor leaf of ``tree`` (dicts, NamedTuples, lists)
    with the spec at the same place in ``specs`` (``place``); other
    leaves (ints) pass through."""
    if isinstance(tree, dict):
        return {k: named(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(named(getattr(tree, f), getattr(specs, f), mesh)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(named(v, s, mesh) for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return place(tree, specs, mesh)
    return tree


def shard_params(params: nn.Module, specs: Dict[str, Spec], mesh,
                 make: Optional[Callable[[str, torch.Tensor, Spec],
                                         torch.Tensor]] = None) -> nn.Module:
    """Replace every parameter of ``params`` by a DTensor parameter of its
    spec, in place.  By default each rank keeps its chunk of the
    parameter it has (``place``); ``make(name, param, spec)`` instead
    returns the local shard itself (a fake tensor, or a shard drawn on the
    card from a meta-device model), which becomes the DTensor's local
    tensor as it is."""
    for full, _ in list(params.named_parameters()):
        mod_name, _, attr = full.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        p = mod._parameters[attr]
        spec = specs[full]
        d = (place(p.detach(), spec, mesh) if make is None
             else from_local(make(full, p, spec), p.shape, spec, mesh))
        mod._parameters[attr] = nn.Parameter(d, requires_grad=False)
    return params


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    return torch.empty(tuple(shape), device="meta").stride()
