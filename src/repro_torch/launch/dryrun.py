"""Production dry-run: run every (arch x input-shape x mesh) combination's
step once on the production mesh, allocating nothing, and read its
roofline terms (counterpart of ``repro.launch.dryrun``).

The reference places 512 host placeholder devices, lowers and compiles
its step on a (16, 16) or (2, 16, 16) mesh, and reads FLOPs, bytes,
memory and collective bytes from XLA.  Here the mesh stands over a fake
process group of 256 or 512 ranks (``launch.mesh``), this process rank
0; parameters, optimiser state, batch and cache are DTensors placed by
``launch.sharding`` whose local shards are fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage), and the step runs
once on them.  A ``TorchDispatchMode`` (``_StepRecorder``) books every
op that runs on rank 0's local shards: its FLOPs (PyTorch's
``flop_counter`` formulas), its input and output bytes, the collectives
DTensor issued (``launch.collectives``) and the live bytes of the fake
tensors it made.

**Why the CPU device.**  The reference's dry-run traces the ``jnp``
oracles, not the Pallas kernels (its ``kernels.ops`` defaults to the
"xla" implementation).  The port's counterpart of the oracles is the
kernels' plain versions, and the CPU device is what selects them
(``kernels.ops`` dispatches by device): the fake shards live on the CPU,
so the step runs the plain versions, on each rank's local heads and rows
(``kernels.ops``' DTensor path).

The record keeps the reference's keys where they mean the same thing:

  * ``flops_per_device``: rank 0's local FLOPs (matmuls, attention
    products, convolutions: what ``flop_counter`` counts);
  * ``bytes_per_device``: the sum of every local op's input and output
    bytes -- an *unfused* upper bound of HBM traffic, not XLA's
    post-fusion count (``bytes_note`` says so);
  * ``collective_bytes_per_device`` and ``collectives``;
  * ``memory``: ``argument_bytes`` (rank 0's local bytes of params,
    optimiser state, batch and cache), ``output_bytes`` (the step's
    outputs that are not its arguments updated in place) and
    ``temp_bytes`` (the peak of live fake bytes the step made);
  * ``roofline`` and ``dominant``, over the H100 SXM's datasheet figures
    (``HARDWARE``), never a TPU's;
  * ``model_flops_total`` / ``_per_device`` and ``useful_flop_ratio``
    (of the config the step ran: a ``cfg_override``'s, where the
    reference reads the arch's own);
  * ``trace_s`` in place of ``lower_s`` / ``compile_s``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out dryrun_results]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.shapes import (InputShape, TensorSpec,
                                        effective_window, token_specs)
from repro_torch.launch import sharding as shr
from repro_torch.launch.collectives import CollectiveRecorder
from repro_torch.launch.mesh import mesh_axis_sizes, production_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.common import ModelConfig, set_activation_sharding
from repro_torch.models.registry import get_model, skeleton
from repro_torch.optim.adamw import AdamWConfig, AdamWState, init_adamw

# NVIDIA H100 SXM datasheet figures (roofline denominators)
PEAK_FLOPS = 989e12      # dense bf16 FLOP/s a card
HBM_BW = 3.35e12         # HBM3 bytes/s a card
LINK_BW = 450e9          # NVLink bytes/s a card, one direction
HARDWARE = ("NVIDIA H100 SXM, 700 W (datasheet: 989e12 dense bf16 FLOP/s, "
            "3.35e12 B/s HBM3, 450e9 B/s NVLink a direction)")
BYTES_NOTE = ("sum of every local aten op's input and output bytes: an "
              "unfused upper bound, not a post-fusion count")

SLICE_LEN = 128  # SCLS slice length: prefill caches are L_i + S (Eq. 5)


class Step(NamedTuple):
    """A step ready to run once on fake shards: ``fn(*args)``."""

    fn: Callable
    args: tuple
    meta: Dict[str, Any]
    fake_mode: FakeTensorMode
    cfg: ModelConfig
    shape: InputShape


# ---------------------------------------------------------------------------
# fake placed inputs
# ---------------------------------------------------------------------------
def _fake_dtensor(shape, dtype: torch.dtype, spec, mesh) -> DTensor:
    """A DTensor of global ``shape`` under ``spec`` whose local shard is
    an empty tensor (fake under the active ``FakeTensorMode``)."""
    return shr.from_local(torch.empty(shr.local_shape(shape, spec, mesh),
                                      dtype=dtype), shape, spec, mesh)


def _place_fake(tree, specs, mesh):
    """Every tensor or ``TensorSpec`` leaf of ``tree`` as a fake DTensor
    of the spec at its place in ``specs``; ints pass through."""
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return _fake_dtensor(tuple(tree.shape), tree.dtype, specs, mesh)
    if isinstance(tree, dict):
        return {k: _place_fake(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_place_fake(getattr(tree, f), getattr(specs, f),
                                        mesh) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_fake(v, s, mesh)
                          for v, s in zip(tree, specs))
    return tree


def _plain_fake_params(cfg: ModelConfig) -> nn.Module:
    """The model's parameters as unplaced fake CPU tensors (call under
    the ``FakeTensorMode``)."""
    params = skeleton(cfg)
    for full, p in list(params.named_parameters()):
        mod_name, _, attr = full.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        mod._parameters[attr] = nn.Parameter(
            torch.empty(p.shape, dtype=p.dtype), requires_grad=False)
    return params


def _ring_write_idx(cache):
    """The cache a prefill of ``cache_window`` tokens leaves: each ring's
    ``write_idx`` at its width (the template's prefill is shorter)."""
    if hasattr(cache, "_fields"):
        fields = {f: _ring_write_idx(getattr(cache, f))
                  for f in cache._fields}
        if "write_idx" in fields and "slot_pos" in fields:
            fields["write_idx"] = fields["slot_pos"].shape[-1]
        return type(cache)(**fields)
    return cache


def _template(tree):
    """``TensorSpec`` of every tensor leaf (ints pass through)."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: _template(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_template(getattr(tree, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_template(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def build_step(arch: str, shape_name: Union[str, InputShape], mesh,
               slice_len: int = SLICE_LEN,
               cfg_override: Optional[ModelConfig] = None,
               fsdp: bool = True, fsdp_min_bytes: int = 0,
               seq_shard: bool = False) -> Step:
    """The right step for (arch, shape) on ``mesh`` with its fake placed
    arguments (the reference's ``build_lowered``).

    Levers: ``fsdp=False`` -- TP-only weights (serving); ``fsdp_min_bytes``
    -- leave small leaves replicated; ``seq_shard`` -- the residual stream
    sequence-sharded over "model" between layers (train shapes).
    ``shape_name`` is a key of ``SHAPES`` or an ``InputShape`` of its
    own."""
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    cfg = cfg_override or get_config(arch)
    if shape.kind == "train":
        cfg = cfg.replace(remat=True)
    window = effective_window(cfg, shape)
    model = get_model(cfg)
    names = mesh.mesh_dim_names
    if seq_shard and shape.seq_len % tuple(mesh.shape)[-1] == 0:
        dp = tuple(a for a in names if a in ("pod", "data"))
        set_activation_sharding(shr.placements((dp, "model", None), mesh))
    else:
        set_activation_sharding(None)

    meta: Dict[str, Any] = dict(arch=arch, shape=shape.name, kind=shape.kind,
                                window=window, fsdp=fsdp, seq_shard=seq_shard,
                                fsdp_min_bytes=fsdp_min_bytes,
                                mesh=mesh_axis_sizes(mesh))
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        params = skeleton(cfg)
        pspecs = shr.param_specs(params, mesh, cfg, fsdp, fsdp_min_bytes)
        opt_t = init_adamw(params) if shape.kind == "train" else None
        shr.shard_params(params, pspecs, mesh, make=lambda _n, p, spec:
                         torch.empty(shr.local_shape(p.shape, spec, mesh),
                                     dtype=p.dtype))
        batch_t = token_specs(cfg, shape)
        batch = _place_fake(batch_t, shr.batch_spec(batch_t, mesh,
                                                     shape.global_batch),
                            mesh)

        if shape.kind == "train":
            ospecs = shr.opt_state_specs(opt_t, params, mesh, cfg, fsdp,
                                         fsdp_min_bytes)
            opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                             mu=_place_fake(opt_t.mu, ospecs.mu, mesh),
                             nu=_place_fake(opt_t.nu, ospecs.nu, mesh))
            step = make_train_step(model, AdamWConfig())
            return Step(step, (params, opt, batch), meta, fake, cfg, shape)

        if shape.kind == "prefill":
            cache_window = shape.seq_len + slice_len  # Eq. (5): L_i + S
            step = make_prefill_step(model, cache_window, window=window)
            return Step(step, (params, batch), meta, fake, cfg, shape)

        # decode: one new token against a cache of seq_len
        if cfg.family in ("ssm", "hybrid"):
            cache_window = shape.seq_len  # constant state / ring
        else:
            cache_window = (shape.seq_len if window is None
                            else min(shape.seq_len, window))
        cache_t = _cache_template(model, cfg, shape, cache_window, window)
        cache = _place_fake(cache_t, shr.cache_spec(cache_t, mesh, cfg,
                                                    shape.global_batch),
                            mesh)
        tok_t = {"t": TensorSpec((shape.global_batch,), torch.int32)}
        tok = _place_fake(tok_t, shr.batch_spec(tok_t, mesh,
                                                shape.global_batch), mesh)
        decode = make_decode_step(model, window=window)
        return Step(decode, (params, cache, tok["t"], 0), meta, fake, cfg,
                    shape)


def _cache_template(model, cfg: ModelConfig, shape: InputShape,
                    cache_window: int, window: Optional[int]):
    """Shapes of the cache a prefill of ``cache_window`` tokens builds:
    a plain fake prefill of a short prompt into the same ``cache_window``
    (the cache's shapes do not depend on the prompt's length), its rings'
    ``write_idx`` then set as the full prefill leaves them."""
    params = _plain_fake_params(cfg)
    batch = {k: v.empty() for k, v in token_specs(cfg, shape).items()}
    T = min(16, cache_window)
    batch["tokens"] = torch.empty((shape.global_batch, T), dtype=torch.int32)
    batch["lengths"] = torch.full((shape.global_batch,), T,
                                  dtype=torch.int32)
    with torch.no_grad():
        cache = model.prefill(params, batch, cache_window, window=window)[1]
    return _template(_ring_write_idx(cache))


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6·N_active·D (training) or 2·N_active·D (single forward token
    batch)."""
    n_params = sum(p.numel() for p in skeleton(cfg).parameters())
    n_active = n_params
    if cfg.n_experts:  # only top_k of n_experts experts run per token
        expert_p = (3 * cfg.d_model * cfg.d_ff_expert
                    * (cfg.n_layers - cfg.first_dense_layers))
        n_active = n_params - expert_p * cfg.n_experts + expert_p * cfg.top_k
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * 1 * shape.global_batch  # decode: 1 token/request


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
def _returns_alias(func) -> bool:
    schema = getattr(func, "_schema", None)
    return schema is not None and any(r.alias_info is not None
                                      for r in schema.returns)


class _StepRecorder(CollectiveRecorder):
    """``CollectiveRecorder`` that also books each local op's FLOPs, its
    input and output bytes, and the live bytes of the tensors it made."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def observe(self, func, args, kwargs, out) -> None:
        super().observe(func, args, kwargs, out)
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if packet is None or func.namespace != "aten":
            return
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if _returns_alias(func):
            return  # a view or an in-place op moves nothing of its own
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            n = t.numel() * t.element_size()
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)


def _local_tensors(x) -> list:
    """The local tensor of every tensor leaf of ``x`` (a DTensor's shard;
    an ``nn.Module`` counts as its parameters)."""
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return [t for v in x for t in _local_tensors(v)]
    leaves = (list(x.parameters()) if isinstance(x, nn.Module)
              else tree_leaves(x))
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in leaves if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def analyse(step: Step, n_chips: int) -> Dict[str, Any]:
    """Run ``step`` once on its fake shards under the recorder; the
    record (the reference's ``analyse``)."""
    args_local = _local_tensors(step.args)
    rec = _StepRecorder()
    t0 = time.time()
    with step.fake_mode, implicit_replication(), rec:
        outputs = step.fn(*step.args)
        outs = [t for t in _local_tensors(outputs)
                if not any(t is a for a in args_local)]
    trace_s = time.time() - t0
    colls = rec.collectives()
    coll_bytes = sum(b for _, b in colls.values())
    flops = float(rec.flops)
    bytes_acc = float(rec.bytes)
    meta = step.meta
    mf = model_flops(step.cfg.replace(remat=False), step.shape)
    terms = dict(compute_s=flops / PEAK_FLOPS,
                 memory_s=bytes_acc / HBM_BW,
                 collective_s=coll_bytes / LINK_BW)
    dominant = max(terms, key=terms.get)
    return dict(
        **meta,
        flops_per_device=flops,
        bytes_per_device=bytes_acc,
        bytes_note=BYTES_NOTE,
        shape_propagation_excluded=rec.propagation_excluded,
        collective_bytes_per_device=coll_bytes,
        collectives={k: dict(count=c, bytes=b) for k, (c, b) in colls.items()},
        memory=dict(argument_bytes=_nbytes(args_local),
                    output_bytes=_nbytes(outs),
                    temp_bytes=rec.peak),
        roofline=terms,
        dominant=dominant,
        hardware=HARDWARE,
        model_flops_total=mf,
        model_flops_per_device=mf / n_chips,
        useful_flop_ratio=(mf / n_chips) / flops if flops else None,
        trace_s=round(trace_s, 2),
    )


def run_one(arch: str, shape_name: Union[str, InputShape], multi_pod: bool,
            out_dir: Optional[str], slice_len: int = SLICE_LEN,
            variant: str = "baseline", mesh=None,
            **build_kw) -> Dict[str, Any]:
    """Build and analyse one combination on the production mesh (or on
    ``mesh``, a fake one the caller owns), writing its record to
    ``out_dir`` when given."""
    if mesh is None:
        with production_mesh(multi_pod) as m:
            return run_one(arch, shape_name, multi_pod, out_dir, slice_len,
                           variant, mesh=m, **build_kw)
    n_chips = math.prod(tuple(mesh.shape))
    try:
        step = build_step(arch, shape_name, mesh, slice_len, **build_kw)
        rec = analyse(step, n_chips)
    finally:
        set_activation_sharding(None)
    rec.update(n_chips=n_chips, multi_pod=multi_pod, status="ok",
               variant=variant)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        vtag = "" if variant == "baseline" else f"_{variant}"
        tag = (f"{arch}_{rec['shape']}_{'pod2' if multi_pod else 'pod1'}{vtag}"
               ).replace("/", "_")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def roofline_line(rec: Dict[str, Any]) -> str:
    r = rec["roofline"]
    return (f"{rec['arch']:24s} {rec['shape']:12s} "
            f"trace={rec['trace_s']:6.1f}s dom={rec['dominant']:12s} "
            f"comp={r['compute_s']:.3e} mem={r['memory_s']:.3e} "
            f"coll={r['collective_s']:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="dryrun_results")
    ap.add_argument("--slice-len", type=int, default=SLICE_LEN)
    ap.add_argument("--variant", default="baseline",
                    help="perf variant tag for the output file")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--fsdp-min-mb", type=float, default=0.0)
    ap.add_argument("--seq-shard", action="store_true")
    args = ap.parse_args(argv)

    combos = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    ok = fail = 0
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, args.multi_pod, args.out,
                          args.slice_len, variant=args.variant,
                          fsdp=not args.no_fsdp,
                          fsdp_min_bytes=int(args.fsdp_min_mb * 1e6),
                          seq_shard=args.seq_shard)
            print("OK   " + roofline_line(rec), flush=True)
            ok += 1
        except Exception as e:
            print(f"FAIL {arch:24s} {shape:12s} {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc()
            fail += 1
    print(f"\n{ok} ok, {fail} failed ({HARDWARE})")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
