"""Weights across frameworks: the JAX parameter tree as a PyTorch
``state_dict`` of the port's model modules (``models.transformer.
Transformer``, ``models.mamba2.Mamba2``).

The JAX tree stacks every per-layer leaf along a leading ``n_layers``
axis (``layers/attn/wq/w`` is ``(n_layers, d_in, d_out)``); the port has
one module per layer (``layers.<i>.attn.wq.w``).  Both keep dense weights
as ``(d_in, d_out)``, so a leaf maps over unchanged.  The mapping is by
name only: the Mamba-2 tree (``layers/mixer/in_proj/w``, ``…/conv_w``,
``…/A_log``, ``layers/ln``, ``ln_f``) carries over the same way, because
the port's module names are the JAX keys; its float32 leaves (``A_log``,
``D``, ``dt_bias``) stay float32 because the port declares them so.
The proxy length predictor's flat dict loads the same way
(``load_proxy_params``).
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
        t = _to_tensor(leaf)
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(t.shape[0]):
                out[f"layers.{i}.{rest}"] = t[i].clone()
        else:
            out[name] = t
    return out


def load_proxy_params(predictor: Any, tree: Mapping[str, Any]) -> None:
    """Load the reference proxy predictor's ``params`` dict (``w1``,
    ``b1``, ``w2``, ``b2`` as numpy arrays, e.g. ``jax.tree.map(np.asarray,
    predictor.params)``) into a ``repro_torch.predict.proxy.ProxyPredictor``
    on its device; ``ProxyMLP`` names and shapes its parameters as the
    dict does, so keys and shapes are checked strictly."""
    predictor.mlp.load_state_dict(params_from_jax(tree))
