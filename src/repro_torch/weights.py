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
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _to_tensor(a: Any) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


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
