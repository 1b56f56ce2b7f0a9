"""Weights across frameworks: the JAX parameter tree as a PyTorch
``state_dict`` of the port's model modules (``models.transformer.
Transformer``, ``models.mamba2.Mamba2``, ``models.moe.MoEModel``,
``models.rglru.RecurrentGemma``, ``models.encdec.EncDecModel``).

The JAX tree stacks every per-layer leaf along a leading axis
(``layers/attn/wq/w`` is ``(n_layers, d_in, d_out)``); the port has one
module per layer (``layers.<i>.attn.wq.w``).  The stacks are the keys of
``STACKED``: ``layers`` and, in the MoE tree, ``dense_layers``; in the
encoder-decoder's, ``enc_layers`` and ``dec_layers``; in the hybrid's,
``groups`` (each holding a stack of two ``rec`` blocks, so
``groups/rec/lru_a/w`` is ``(G, 2, d, d)`` and lands on
``groups.<g>.rec.<j>.lru_a.w``) and ``tail``.  Both keep dense weights as
``(d_in, d_out)``, so a leaf maps over unchanged; the stacked experts
(``layers/moe/experts/gate/w``, ``(L, E, d, d_ff)``) stay one ``(E, d,
d_ff)`` tensor a layer.  The mapping is by name only, because the port's
module names are the JAX keys; float32 leaves (Mamba-2's ``A_log``, ``D``,
``dt_bias``, the MoE ``router``, the RG-LRU ``lambda``) stay float32
because the port declares them so.  The proxy length predictor's flat
dict loads the same way (``load_proxy_params``).

The reverse, ``params_to_jax``, restacks the port's modules into the JAX
tree of numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives,
which ``checkpoint.store`` writes).  numpy has no bfloat16 without
``ml_dtypes``, so a bfloat16 leaf comes out as a 2-byte void array
(``|V2``) holding its bits: the bytes, and the dtype, that ``np.savez``
writes for a JAX bfloat16 array.  ``jax_path`` maps a parameter's name to
its leaf's key path and its index along the stacked axes, which the
optimiser uses to keep its moments in the JAX tree's layout.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

#: numpy's dtype for a bfloat16 leaf: 2 raw bytes (``np.savez``'s ``|V2``)
BF16_VOID = np.dtype("V2")


def _to_tensor(a: Any) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as ``|V2`` bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_VOID)
    return t.numpy()


#: keys of the JAX tree whose leaves stack one module a layer (or a block)
#: along their leading axis
STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers", "groups",
           "rec", "tail")


def _unstack(parts, t: torch.Tensor):
    """(name, tensor) of each module along the stacked axes of ``parts``
    (a leaf's key path): the leading axis of ``t`` is split after every
    ``STACKED`` key, the index inserted into the name."""
    if not parts:
        yield "", t
        return
    head, rest = parts[0], parts[1:]
    if head in STACKED and rest:
        for i in range(t.shape[0]):
            for name, leaf in _unstack(rest, t[i]):
                yield f"{head}.{i}.{name}", leaf
    else:
        for name, leaf in _unstack(rest, t):
            yield (f"{head}.{name}" if name else head), leaf


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the model's ``load_state_dict`` from the JAX
    parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``).  Tensors are on the CPU;
    ``load_state_dict`` copies them onto the module's device and type."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(tree):
        for key, t in _unstack(name.split("."), _to_tensor(leaf)):
            out[key] = t.clone()
    return out


def load_proxy_params(predictor: Any, tree: Mapping[str, Any]) -> None:
    """Load the reference proxy predictor's ``params`` dict (``w1``,
    ``b1``, ``w2``, ``b2`` as numpy arrays, e.g. ``jax.tree.map(np.asarray,
    predictor.params)``) into a ``repro_torch.predict.proxy.ProxyPredictor``
    on its device; ``ProxyMLP`` names and shapes its parameters as the
    dict does, so keys and shapes are checked strictly."""
    predictor.mlp.load_state_dict(params_from_jax(tree))


def jax_path(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(key path of the JAX leaf, index along its stacked axes) of the
    port's parameter ``name``: ``groups.3.rec.1.lru_a.w`` is
    ``(("groups", "rec", "lru_a", "w"), (3, 1))``."""
    parts = name.split(".")
    path, index = [], []
    i = 0
    while i < len(parts):
        path.append(parts[i])
        if (parts[i] in STACKED and i + 1 < len(parts)
                and parts[i + 1].isdigit()):
            index.append(int(parts[i + 1]))
            i += 2
        else:
            i += 1
    return tuple(path), tuple(index)


def stack_tree(params: nn.Module, leaf=lambda t: t) -> Dict[str, Any]:
    """The JAX tree (nested dicts) of the model ``params``: each leaf the
    parameters of its key path stacked along their indices, in the
    stacked order, and passed through ``leaf``."""
    groups: Dict[Tuple[str, ...], Dict[Tuple[int, ...], torch.Tensor]] = {}
    for name, t in params.named_parameters():
        path, index = jax_path(name)
        groups.setdefault(path, {})[index] = t.detach()
    tree: Dict[str, Any] = {}
    for path, parts in groups.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf(_stack(parts))
    return tree


def _stack(parts: Dict[Tuple[int, ...], torch.Tensor]) -> torch.Tensor:
    """Tensors keyed by their index along k stacked axes -> one tensor
    with those k leading axes."""
    if list(parts) == [()]:
        return parts[()]
    heads = sorted({i[0] for i in parts})
    if heads != list(range(len(heads))):
        raise ValueError(f"stacked indices {heads} are not 0..n-1")
    return torch.stack([_stack({i[1:]: t for i, t in parts.items()
                                if i[0] == h}) for h in heads])


def params_to_jax(params: nn.Module) -> Dict[str, Any]:
    """The JAX parameter tree (nested dicts of numpy arrays, bfloat16 as
    ``|V2``) of the port's model: the reverse of ``params_from_jax``."""
    return stack_tree(params, to_numpy)
