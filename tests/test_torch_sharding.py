"""The port's sharding rules, input shapes and model FLOPs against the JAX
package's (``repro_torch.launch.sharding`` / ``repro.launch.sharding``,
``configs.shapes``, ``launch.dryrun.model_flops``).

The JAX side runs on stand-in meshes (``axis_names`` and a
``devices.shape``, no devices) and ``jax.eval_shape`` trees, the port's
on ``MeshShape``s and its meta-device parameter modules: no test here
allocates a full-size model or builds a process group.  Placements are
compared leaf for leaf (the JAX ``PartitionSpec`` turned into one
DTensor placement a mesh dim), per-device bytes exactly.
"""
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard


ARCHS = ("llama3.2-1b", "codeqwen1.5-7b", "minitron-4b", "gemma-2b",
         "mamba2-130m", "deepseek-v2-lite-16b", "mixtral-8x22b",
         "recurrentgemma-9b", "seamless-m4t-large-v2", "paligemma-3b")
MESHES = ((("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)))
#: fsdp on, off, and on with a floor that leaves the smaller leaves whole
VARIANTS = (dict(fsdp=True, fsdp_min_bytes=0),
            dict(fsdp=False, fsdp_min_bytes=0),
            dict(fsdp=True, fsdp_min_bytes=1 << 22))
#: one model per family for the batch and cache rules
FAMILY_ARCHS = ("llama3.2-1b", "mamba2-130m", "deepseek-v2-lite-16b",
                "mixtral-8x22b", "recurrentgemma-9b",
                "seamless-m4t-large-v2", "paligemma-3b")


def _jax_mesh(names, shape):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _port_mesh(names, shape):
    from repro_torch.launch.sharding import MeshShape
    return MeshShape(names, shape)


def _as_placements(spec, names):
    """A JAX ``PartitionSpec`` as DTensor placements (one a mesh dim),
    made here independently of the port's ``placements``."""
    out = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        for name in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(name)] = Shard(d)
    return tuple(out)


def _by_path(tree, is_leaf):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _leaf_bytes(shape, itemsize, spec, sizes):
    """Per-device bytes of a leaf under a JAX spec (ceil-divided)."""
    shape = list(shape)
    for d, entry in enumerate(tuple(spec)):
        for name in (() if entry is None else
                     (entry,) if isinstance(entry, str) else entry):
            shape[d] = -(-shape[d] // sizes[name])
    return math.prod(shape) * itemsize


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    from repro.configs import get_config
    from repro.models.registry import get_model
    from repro.optim.adamw import init_adamw
    cfg = get_config(arch)
    params = jax.eval_shape(get_model(cfg).init,
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return cfg, params, jax.eval_shape(init_adamw, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_equal_jax_leaf_for_leaf(arch):
    """For every arch at full size, on both production meshes, with fsdp
    on, off and with ``fsdp_min_bytes``: ``tree_pspecs`` of the parameter
    tree and of the AdamW state equal JAX's, leaf for leaf; the port's
    per-layer tensors (``param_specs``) and its moments
    (``opt_state_specs``) hold exactly the JAX specs' per-device bytes;
    and ``param_pspec`` on slash-free paths (the tensor-parallel classes,
    which JAX's tree walk never reaches) equals JAX's ``param_pspec``."""
    from repro.launch import sharding as jshr
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import TensorSpec
    from repro_torch.launch import sharding as shr
    from repro_torch.models.registry import skeleton
    from repro_torch.optim.adamw import AdamWState
    jcfg, jparams, jopt = _jax_trees(arch)
    cfg = get_config(arch)
    params = skeleton(cfg)
    template = shr.stacked_template(params)
    moments = jax.tree.map(lambda x: TensorSpec(x.shape, torch.float32),
                           template, is_leaf=lambda x: hasattr(x, "shape"))
    opt_t = AdamWState(step=TensorSpec((), torch.int32), mu=moments,
                       nu=moments)
    jleaves = _by_path(jparams, None)
    assert set(_by_path(template, lambda x: hasattr(x, "shape"))) == \
        set(jleaves)
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    is_pl = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(p, (Shard, Replicate)) for p in x)
    for names, shape in MESHES:
        jm, pm = _jax_mesh(names, shape), _port_mesh(names, shape)
        sizes = dict(zip(names, shape))
        for kw in VARIANTS:
            for jtree, ptree in ((jparams, template), (jopt, opt_t)):
                want = {k: _as_placements(s, names) for k, s in _by_path(
                    jshr.tree_pspecs(jtree, jm, jcfg, **kw), is_p).items()}
                got = _by_path(shr.tree_pspecs(ptree, pm, cfg, **kw), is_pl)
                assert got == want, (names, kw)
            jspecs = _by_path(jshr.tree_pspecs(jparams, jm, jcfg, **kw), is_p)
            want_bytes = sum(_leaf_bytes(jleaves[k].shape,
                                         jleaves[k].dtype.itemsize, s, sizes)
                             for k, s in jspecs.items())
            specs = shr.param_specs(params, pm, cfg, **kw)
            got_bytes = sum(shr.spec_bytes(p.shape, p.element_size(),
                                           specs[n], pm)
                            for n, p in params.named_parameters())
            assert got_bytes == want_bytes, (names, kw)
            # the moments: float32, stacked, their specs moved off the
            # stacked axes
            ospecs = shr.opt_state_specs(opt_t, params, pm, cfg, **kw)
            got_m = sum(shr.spec_bytes(leaf.shape, 4, s, pm) for leaf, s in
                        zip(jax.tree.leaves(template, is_leaf=lambda x:
                                            hasattr(x, "shape")),
                            jax.tree.leaves(ospecs.mu, is_leaf=lambda x:
                                            isinstance(x, tuple))))
            jmu = _by_path(jshr.tree_pspecs(jopt, jm, jcfg, **kw).mu, is_p)
            want_m = sum(_leaf_bytes(jleaves[k].shape, 4, s, sizes)
                         for k, s in jmu.items())
            assert got_m == want_m, (names, kw)
        for key, leaf in jleaves.items():
            path = "/".join(key.strip("[]'").split("']['"))
            want = _as_placements(jshr.param_pspec(path, leaf, jm, jcfg),
                                  names)
            got = shr.param_pspec(path, TensorSpec(leaf.shape, getattr(
                torch, leaf.dtype.name)), pm, cfg)
            assert got == want, (names, path)


def test_shapes_windows_and_token_specs_equal_jax():
    """``SHAPES``, ``effective_window`` (every arch x shape) and
    ``token_specs``' shapes and dtypes equal JAX's."""
    from repro.configs import get_config as jax_config
    from repro.configs import shapes as jshapes
    from repro_torch.configs import get_config
    from repro_torch.configs import shapes
    assert {k: tuple(vars(v).values()) for k, v in shapes.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert cfg.long_context_window == jcfg.long_context_window
        for name in shapes.SHAPES:
            assert shapes.effective_window(cfg, shapes.SHAPES[name]) == \
                jshapes.effective_window(jcfg, jshapes.SHAPES[name])
            got = shapes.token_specs(cfg, shapes.SHAPES[name])
            want = jshapes.token_specs(jcfg, jshapes.SHAPES[name])
            assert {k: (v.shape, str(v.dtype).split(".")[-1])
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
                 for k, v in want.items()}, (arch, name)
            assert got["tokens"].empty().shape == got["tokens"].shape


def test_model_flops_equal_jax():
    """``dryrun.model_flops`` equals JAX's for all 40 combinations."""
    from repro.configs import get_config as jax_config
    from repro.configs import shapes as jshapes
    from repro.launch import dryrun as jdry
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            assert dryrun.model_flops(get_config(arch), shape) == \
                jdry.model_flops(jax_config(arch), jshapes.SHAPES[name]), \
                (arch, name)


def _np_batch(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 3, T - 1, T - 5][:B], np.int32)
    b = {"tokens": rng.integers(2, cfg.vocab_size, size=(B, T)
                                ).astype(np.int32), "lengths": lengths}
    if cfg.family == "encdec":
        b["src_embeds"] = rng.standard_normal((B, 6, cfg.d_model)).astype(
            np.float32)
        b["src_valid"] = np.ones((B, 6), bool)
    if cfg.family == "vlm":
        b["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return b


def _pairs(tree, specs):
    """(tensor, spec) of every tensor leaf of a port cache, in order."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if hasattr(tree, "_fields"):
        return [p for f in tree._fields
                for p in _pairs(getattr(tree, f), getattr(specs, f))]
    return []


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_and_cache_placements_equal_jax(arch):
    """``batch_pspec`` and ``cache_pspec`` of every family's reduced
    prefill cache (batch 4, cache window 16) equal JAX's on a (2, 2) and a
    (2, 2, 2) mesh, leaf by leaf where the two caches' leaves have one
    shape, and in per-device bytes over the whole cache either way (JAX's
    ``write_idx`` is a 0-d array, the port's a Python int: the 0-d leaves
    are left out of the sum)."""
    from repro.configs import get_config as jax_config
    from repro.launch import sharding as jshr
    from repro.models.registry import get_model as jax_model
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shr
    from repro_torch.models.registry import get_model
    jmodel = jax_model(jax_config(arch, reduced=True))
    tm = get_model(get_config(arch, reduced=True))
    tp = tm.init(0, device="cpu")
    B, T, W = 4, 8, 16
    nb = _np_batch(tm.cfg, B, T)
    jp = jax.eval_shape(jmodel.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jcache = jax.eval_shape(lambda p, b: jmodel.prefill(p, b, W)[1], jp,
                            {k: jnp.asarray(v) for k, v in nb.items()})
    with torch.no_grad():
        tcache = tm.prefill(tp, {k: torch.from_numpy(v)
                                 for k, v in nb.items()}, W)[1]
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    for names, shape in ((("data", "model"), (2, 2)),
                         (("pod", "data", "model"), (2, 2, 2))):
        jm, pm = _jax_mesh(names, shape), _port_mesh(names, shape)
        sizes = dict(zip(names, shape))
        want_b = {k: _as_placements(s, names) for k, s in
                  jshr.batch_pspec(nb, jm, B).items()}
        assert shr.batch_pspec(nb, pm, B) == want_b
        jleaves = jax.tree.leaves(jcache)
        jspecs = jax.tree.leaves(jshr.cache_pspec(jcache, jm, jmodel.cfg, B),
                                 is_leaf=is_p)
        by_shape = {tuple(x.shape): _as_placements(s, names)
                    for x, s in zip(jleaves, jspecs) if x.ndim}
        placed = _pairs(tcache, shr.cache_pspec(tcache, pm, tm.cfg, B))
        matched = 0
        for x, pl in placed:
            if tuple(x.shape) in by_shape:
                assert pl == by_shape[tuple(x.shape)], (names, x.shape)
                matched += 1
        assert matched
        want = sum(_leaf_bytes(x.shape, x.dtype.itemsize, s, sizes)
                   for x, s in zip(jleaves, jspecs) if x.ndim)
        got = sum(shr.spec_bytes(x.shape, x.element_size(), s, pm)
                  for x, s in _pairs(tcache, shr.cache_spec(tcache, pm,
                                                            tm.cfg, B)))
        assert got == want, names


def test_layer_spec_moves_a_stacked_axis():
    """``stacked_spec`` / ``layer_spec`` move an axis off a stacked dim onto
    the first dim it divides (on top of what shards it already), keep the
    stacked dims whole, and drop an axis no dim takes."""
    from repro_torch.launch.sharding import MeshShape, layer_spec, \
        stacked_spec
    m = MeshShape(("data", "model"), (4, 2))
    assert layer_spec(("data", None, None), (8, 12, 6), 1, m) == \
        ("data", None)
    assert layer_spec(("data", None, "model"), (8, 6, 16), 1, m) == \
        (None, ("data", "model"))
    assert stacked_spec(("data", None), (8, 6), 1, m) == (None, None)
    assert stacked_spec((None, "data", None, None), (3, 4, 5, 8), 2, m) \
        == (None, None, None, "data")
