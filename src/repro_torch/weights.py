"""Weights across frameworks: the JAX parameter tree as a PyTorch
``state_dict`` of ``models.transformer.Transformer``.

The JAX tree stacks every per-layer leaf along a leading ``n_layers``
axis (``layers/attn/wq/w`` is ``(n_layers, d_in, d_out)``); the port has
one module per layer (``layers.<i>.attn.wq.w``).  Both keep dense weights
as ``(d_in, d_out)``, so a leaf maps over unchanged.
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
    """A ``state_dict`` for ``Transformer.load_state_dict`` from the JAX
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
