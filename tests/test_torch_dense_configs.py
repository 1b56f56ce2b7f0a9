"""The dense configs the port serves beside llama3.2-1b, against the JAX
package on shared weights at their reduced float32 sizes:

* codeqwen1.5-7b: QKV bias, MHA, an untied head, θ 1e6;
* minitron-4b: GQA 24/8, an untied head;
* gemma-2b: GeGLU, embeddings scaled by sqrt(d_model), MQA 8/1, tied.

The llama3.2-1b tests of ``test_torch_models``, ``test_torch_engine`` and
``test_torch_continuous`` run again per arch through their shared helpers
(logits at ``LOGIT_TOL``, blocks at ``BLOCK_TOL``, streams equal but for
recorded near-ties).  JAX's init makes the QKV biases zero, so
``torch_port.shared_models`` draws them apart on both sides; an untied head
is JAX's own random ``unembed/w``.  gemma-2b runs once more at head_dim
256, the decode and prefill kernels' widest head, through the plain
versions of flash_prefill, decode_attention, paged_decode_attention and
fused_rope_decode_append."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.models import common as tcommon
from test_torch_continuous import _paged, _pair
from test_torch_engine import check_fused_multi_slice, \
    check_multi_slice_retention
from test_torch_models import (BLOCK_TOL, _np, check_dense_prefill_and_decode,
                               check_mlp, check_paged_prefill_and_decode,
                               check_paged_tail_prefill, check_params_carry)
from torch_port import assert_same_stream, prompts, shared_models

ARCHS = ("codeqwen1.5-7b", "minitron-4b", "gemma-2b")


# ---------------------------------------------------------------------------
# configs, weights and the new building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_field_for_field(arch, reduced):
    """Every field the port's config has equals the JAX config's, the
    dtype by name (the port keeps its own copy of each config)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config as torch_config
    tcfg, jcfg = torch_config(arch, reduced), jax_config(arch, reduced)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            got, want = str(got).split(".")[-1], jnp.dtype(want).name
        assert got == want, f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    """Every leaf, the QKV biases and the untied head included, lands in
    the port's module with its JAX values."""
    models = shared_models(arch)
    check_params_carry(models)
    jm, jp, tm, tp = models
    if tm.cfg.qkv_bias:
        for name in ("wq", "wk", "wv"):
            want = np.asarray(jp["layers"]["attn"][name]["b"][1])
            got = _np(getattr(tp.layers[1].attn, name).b)
            np.testing.assert_array_equal(got, want)
            assert np.abs(want).max() > 0.1   # drawn apart from JAX's zeros
    if not tm.cfg.tie_embeddings:
        np.testing.assert_array_equal(_np(tp.unembed.w),
                                      np.asarray(jp["unembed"]["w"]))
    else:
        assert tp.unembed is None and "unembed" not in jp


def test_init_draws_an_untied_head_and_zero_biases():
    """The port's initialiser: QKV biases zero (``dense_param``), an
    untied head N(0, 1/d_model) from the generator, apart from the table."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    tm = get_model(get_config("codeqwen1.5-7b", reduced=True))
    a, b = tm.init(3, device="cpu"), tm.init(4, device="cpu")
    for name in ("wq", "wk", "wv"):
        assert not getattr(a.layers[0].attn, name).b.any()
    assert a.layers[0].attn.wo.b is None
    d = tm.cfg.d_model
    assert a.unembed.w.shape == (d, tm.cfg.vocab_size)
    assert abs(float(a.unembed.w.std()) - d ** -0.5) < 5e-3
    assert not torch.equal(a.unembed.w, b.unembed.w)
    assert not torch.equal(a.unembed.w, a.embed.table.T)
    assert get_model(get_config("gemma-2b", reduced=True)).init(
        3, device="cpu").unembed is None


@pytest.mark.parametrize("name", ["wq", "wk", "wv"])
def test_biased_dense_matches_jax(name):
    """codeqwen's q, k and v projections with their biases, at
    ``BLOCK_TOL``, and without the bias they would differ."""
    jm, jp, tm, tp = shared_models("codeqwen1.5-7b")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, tm.cfg.d_model)).astype(np.float32)
    layer = jax.tree.map(lambda a: a[0], jp["layers"])["attn"][name]
    want = np.asarray(jcommon.dense_apply(layer, jnp.asarray(x)))
    dense = getattr(tp.layers[0].attn, name)
    got = _np(dense(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=BLOCK_TOL)
    assert np.abs(_np(torch.from_numpy(x) @ dense.w) - want).max() > 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_matches_jax(arch):
    """SwiGLU (codeqwen, minitron) and GeGLU (gemma: GELU's tanh
    approximation, as ``jax.nn.gelu(approximate=True)``)."""
    check_mlp(shared_models(arch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_matches_jax_bit_for_bit(dtype):
    """gemma-2b's embedding at its published d_model 2048: sqrt(2048)
    rounded to the table's type first (45.25 in bf16), then one rounded
    product, bit for bit as JAX computes it."""
    from repro_torch.configs import get_config
    tcfg = get_config("gemma-2b")
    jcfg = jcommon.ModelConfig(d_model=tcfg.d_model, scale_embed=True)
    rng = np.random.default_rng(12)
    table = rng.standard_normal((16, tcfg.d_model)).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    toks = np.array([[3, 0, 15, 7]], np.int32)
    want = np.asarray(jcommon.embed_apply({"table": jnp.asarray(table)},
                                          jnp.asarray(toks), jcfg))
    emb = tcommon.Embed(16, tcfg.d_model, getattr(torch, dtype),
                        torch.device("cpu"))
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table.view(np.int16)).view(
            torch.bfloat16) if dtype == "bfloat16"
            else torch.from_numpy(table))
    got = tcommon.embed_apply(emb, torch.from_numpy(toks), tcfg)
    ints = {"float32": (torch.int32, np.int32),
            "bfloat16": (torch.int16, np.int16)}[dtype]
    np.testing.assert_array_equal(got.view(ints[0]).numpy(),
                                  want.view(ints[1]))
    if dtype == "bfloat16":
        assert tcommon.embed_scale(tcfg, torch.bfloat16) == 45.25


# ---------------------------------------------------------------------------
# the serving functions: dense and paged, unfused and fused
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_prefill_and_decode_match_jax(arch):
    check_dense_prefill_and_decode(shared_models(arch))


@pytest.mark.parametrize("impl", ["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_logits_match_jax(arch, impl):
    """The QKV biases go in before RoPE on either path: the fused kernels'
    plain versions rotate the biased k."""
    check_paged_prefill_and_decode(shared_models(arch), impl)


@pytest.mark.parametrize("impl", ["unfused", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_tail_prefill_logits_match_jax(arch, impl):
    """Stage A' (a tail past two shared pages, and for the fused write a
    start in the middle of a page)."""
    for start in ((16,) if impl == "unfused" else (16, 13)):
        check_paged_tail_prefill(shared_models(arch), impl, start)


# ---------------------------------------------------------------------------
# the engines' token streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_static_engines_stream_jax_tokens(arch):
    """``StaticEngine(kv_layout="paged")``, unfused and fused, over three
    retained slices: the JAX engines' streams and counts."""
    models = shared_models(arch)
    check_multi_slice_retention(models, arch)
    check_fused_multi_slice(models, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_static_engine_streams_jax_tokens(arch):
    """The dense ``StaticEngine.serve_batch`` (the launcher's SCLS path)
    over two slices, the second re-prefilling prompt + generated tokens."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = shared_models(arch)
    jeng = JaxEngine(jm, jp, eos_id=1, len_bucket=8)
    teng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
    ps = prompts(tm.cfg.vocab_size, [5, 11, 8], seed=13)
    outs = [[] for _ in ps]
    for forced in ([6, 6, 6], [5, 2, 6]):
        kw = dict(forced_gen_lens=forced, already_generated=outs)
        want = jeng.serve_batch(ps, 6, **kw)
        got = teng.serve_batch(ps, 6, **kw)
        assert got.reprefill_tokens == want.reprefill_tokens
        assert got.steps == want.steps
        for p, a, b in zip(ps, want.results, got.results):
            assert_same_stream(p, a["tokens"], b["tokens"], arch)
        outs = [o + r["tokens"] for o, r in zip(outs, want.results)]
    assert want.reprefill_tokens > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_streams_jax_tokens(arch, layout):
    """The ILS baseline: join order, iterations and streams."""
    models = shared_models(arch)
    jeng, teng = _pair(models, **(_paged() if layout == "paged" else {}))
    ps = prompts(models[2].cfg.vocab_size, [5, 9, 4], seed=3)
    kw = dict(forced_gen_lens=[4, 6, 3])
    want, got = jeng.serve(ps, **kw), teng.serve(ps, **kw)
    assert got.join_order == want.join_order
    assert got.iterations == want.iterations
    for p, a, b in zip(ps, want.outputs, got.outputs):
        assert_same_stream(p, a, b, arch)
    if teng.alloc is not None:
        assert teng.alloc.free_blocks == teng.alloc.n_pages


# ---------------------------------------------------------------------------
# head_dim 256: the kernels' plain versions at gemma-2b's published head
# ---------------------------------------------------------------------------
def test_gemma_at_head_dim_256_matches_jax():
    """The reduced gemma-2b with its published head_dim 256 on both sides
    (4/1 heads): dense prefill + decode (flash_prefill, decode_attention),
    the paged unfused path (flash_prefill, paged_decode_attention) and
    the fused one (fused_rope_decode_append), each at ``LOGIT_TOL``, with
    every plain version counted at D 256."""
    from repro_torch.kernels import ops
    models = shared_models("gemma-2b", head_dim=256)
    assert models[2].cfg.head_dim == 256 == models[0].cfg.head_dim
    L = models[2].cfg.n_layers
    ops.reset_counts()
    check_dense_prefill_and_decode(models)
    assert ops.plain_calls["flash_prefill"] == L
    assert ops.plain_calls["decode_attention"] == 3 * L
    for impl in ("unfused", "fused"):
        check_paged_prefill_and_decode(models, impl)
    assert ops.plain_calls["paged_decode_attention"] == 4 * L
    assert ops.plain_calls["fused_rope_decode_append"] == 4 * L


@pytest.mark.parametrize("arch", ("llama3.2-1b",) + ARCHS)
def test_forward_matches_jax(arch):
    """The full-sequence forward (plain torch attention, no cache: the
    reference ``chip_smoke.py`` holds the served paths against on the
    card) over two left-padded rows, every position's logits at
    ``LOGIT_TOL``."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    from test_torch_models import LOGIT_TOL, _left_pad
    jm, jp, tm, tp = shared_models(arch)
    toks, lens = _left_pad(tm.cfg.vocab_size, [12, 7], 12, seed=14)
    tt = torch.from_numpy(toks)
    pos = ttfm.make_positions(tt, torch.from_numpy(lens))
    want = jtfm.forward(jp, jm.cfg, jnp.asarray(toks), jnp.asarray(_np(pos)))
    with torch.no_grad():
        got = ttfm.forward(tp, tm.cfg, tt, pos)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_TOL)
