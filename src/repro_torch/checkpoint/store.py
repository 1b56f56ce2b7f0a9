"""Checkpointing in the JAX package's format (counterpart of
``repro.checkpoint.store``): ``arrays.npz`` holding every leaf under its
``|``-joined key path (``params|layers|attn|wq|w``, ``opt|step``,
``opt|mu|…``, ``opt|nu|…``; dict keys in sorted order, a NamedTuple's in
field order, as the reference's ``_flatten`` walks them) and
``manifest.json`` (``step``, ``extra``).  The parameters are written as
the JAX tree (``weights.params_to_jax``: per-layer modules restacked), so
the two packages' checkpoints load in each other both ways.

A bfloat16 leaf is stored as raw 2-byte voids (``|V2``), which is what
``np.savez`` makes of a JAX bfloat16 array; ``load_checkpoint`` reads
such a leaf back as bfloat16 by its template's dtype (the reference's
loader hands the voids back untyped: ROADMAP C6).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.weights import (BF16_VOID, jax_path, params_to_jax,
                                 to_numpy)


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):  # jax flattens dicts in sorted-key order
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _host(leaf) -> np.ndarray:
    return to_numpy(leaf) if isinstance(leaf, torch.Tensor) else \
        np.asarray(leaf)


def save_checkpoint(path: str, params: nn.Module, opt_state=None,
                    step: int = 0, extra: Optional[dict] = None) -> None:
    """Write ``params`` (the port's model) and the optimiser state (an
    ``optim.adamw.AdamWState``) to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays = _flatten({"params": params_to_jax(params)})
    if opt_state is not None:
        arrays.update(_flatten({"opt": opt_state}))
    np.savez(os.path.join(path, "arrays.npz"),
             **{k.replace("/", "|"): _host(v) for k, v in arrays.items()})
    manifest = {"step": step, "extra": extra or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _into(dst: torch.Tensor, src: np.ndarray, key: str) -> None:
    """Copy the stored leaf ``src`` (a contiguous, writable array) into
    ``dst``, in place: the same shape and type (``|V2`` read as
    bfloat16), or an error."""
    if src.dtype == BF16_VOID:
        if dst.dtype != torch.bfloat16:
            raise ValueError(f"{key}: 2-byte voids (bfloat16) for a "
                             f"{dst.dtype} template")
        t = torch.from_numpy(src.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(src)
    if t.dtype != dst.dtype or tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: stored {t.dtype} {tuple(t.shape)}, "
                         f"template {dst.dtype} {tuple(dst.shape)}")
    dst.copy_(t)


@torch.no_grad()
def load_checkpoint(path: str, params_template: nn.Module,
                    opt_template=None) -> Tuple[nn.Module, Any, int, dict]:
    """(params, opt_state, step, extra) from the directory ``path``: the
    templates (a model of the checkpoint's config, an ``AdamWState`` such
    as ``init_adamw`` gives) filled in place, on their devices."""
    data = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    stored: Dict[str, np.ndarray] = {}

    def leaf(key: str) -> np.ndarray:
        if key not in stored:
            stored[key] = data[key.replace("/", "|")]
        return stored[key]

    for name, p in params_template.named_parameters():
        keys, index = jax_path(name)
        key = "/".join(("params",) + keys)
        _into(p, leaf(key)[index], key)  # a leading index: contiguous
    stored.clear()
    if opt_template is not None:
        for key, t in _flatten({"opt": opt_template}).items():
            _into(t, leaf(key), key)
    return params_template, opt_template, manifest["step"], manifest["extra"]
