"""The port's last public helpers against the JAX package's:
``repro_torch.kvcache``'s ``append_prefill``, ``gather_row`` and the
``PagedKVCache.page_tokens`` / ``n_pages`` properties (the same seeded
inputs through both, results equal),
``repro_torch.engine.sampling.temperature_sample`` (JAX's PRNG stream is
not reproduced: the top-k support, the zero-temperature limit and the
frequencies of a seeded run are held to JAX's rule instead),
``repro_torch.configs.all_configs`` (the same names and fields) and
``DocsRefsPass.count_refs`` (the same counts over the repository's
documents)."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import sampling as jsampling
from repro.kvcache import paged as jpaged
from repro_torch.engine import sampling
from repro_torch.kvcache import (append_prefill, gather_row,
                                 init_paged_kv_cache, write_prefill_pages)


def _both(L, batch, n_pages, pg, nb, Hkv, D):
    ours = init_paged_kv_cache(L, batch=batch, n_pages=n_pages,
                               page_tokens=pg, max_blocks_per_row=nb,
                               n_kv=Hkv, head_dim=D, dtype=torch.float32,
                               device=torch.device("cpu"))
    theirs = jpaged.init_paged_kv_cache(L, batch=batch, n_pages=n_pages,
                                        page_tokens=pg,
                                        max_blocks_per_row=nb, n_kv=Hkv,
                                        head_dim=D, dtype=jnp.float32)
    return ours, theirs


def _same(ours, theirs):
    for name in ("k_pages", "v_pages", "block_table", "slot_pos", "lengths"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)


def test_page_tokens_and_n_pages_match_jax():
    ours, theirs = _both(2, 2, 6, 4, 3, 2, 8)
    assert (ours.page_tokens, ours.n_pages, ours.window) == \
        (theirs.page_tokens, theirs.n_pages, theirs.window) == (4, 7, 12)


def test_gather_row_after_prefill_matches_jax():
    """tests/test_kvcache.py's prefill write, read back through both
    packages' gather_row."""
    L, pg, Hkv, D = 2, 4, 2, 8
    ours, theirs = _both(L, 2, 6, pg, 3, Hkv, D)
    rng = np.random.default_rng(0)
    k = rng.standard_normal((L, 6, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((L, 6, Hkv, D)).astype(np.float32)
    sp = np.array([-1, 0, 1, 2, 3, 4], np.int32)
    ours = write_prefill_pages(ours, 0, [3, 5], torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(sp), 5)
    theirs = jpaged.write_prefill_pages(theirs, 0, [3, 5], jnp.asarray(k),
                                        jnp.asarray(v), sp, 5)
    _same(ours, theirs)
    for got, want in zip(gather_row(ours, 0), jpaged.gather_row(theirs, 0)):
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert (gather_row(ours, 0)[0][:, 8:] == 0).all()  # the null page


@pytest.mark.parametrize("pg", [1, 4, 5])
def test_append_prefill_compact_round_trip_matches_jax(pg):
    """A prefix, then a delta that starts mid-page: the prefix intact, the
    delta at slot == position, every tensor equal to JAX's."""
    L, Hkv, D = 2, 1, 8
    nb = -(-8 // pg) + 1
    ours, theirs = _both(L, 2, 2 * nb, pg, nb, Hkv, D)
    pages = list(range(2, 2 + -(-8 // pg)))
    rng = np.random.default_rng(pg)
    k1, v1 = (rng.standard_normal((L, 5, Hkv, D)).astype(np.float32)
              for _ in range(2))
    k2, v2 = (rng.standard_normal((L, 3, Hkv, D)).astype(np.float32)
              for _ in range(2))
    for k, v, start, n in ((k1, v1, 0, 5), (k2, v2, 5, 3)):
        ours = append_prefill(ours, 1, pages, torch.from_numpy(k),
                              torch.from_numpy(v), start, n)
        theirs = jpaged.append_prefill(theirs, 1, pages, jnp.asarray(k),
                                       jnp.asarray(v), start, n)
        _same(ours, theirs)
    gk, gv = gather_row(ours, 1)
    np.testing.assert_array_equal(gk[:, :5], k1)   # prefix intact
    np.testing.assert_array_equal(gv[:, 5:8], v2)  # appended
    assert int(ours.lengths[1]) == 8
    np.testing.assert_array_equal(ours.slot_pos[1, :9].numpy(),
                                  list(range(8)) + [-1])


def test_append_prefill_overflow_raises_as_jax():
    ours, theirs = _both(2, 1, 4, 4, 3, 1, 8)
    k = np.zeros((2, 5, 1, 8), np.float32)
    with pytest.raises(ValueError):
        jpaged.append_prefill(theirs, 0, [2], jnp.asarray(k), jnp.asarray(k),
                              start=0, n_new=5)
    with pytest.raises(ValueError):
        append_prefill(ours, 0, [2], torch.from_numpy(k),
                       torch.from_numpy(k), start=0, n_new=5)
    with pytest.raises(ValueError):  # more pages than the block table
        append_prefill(ours, 0, [1, 2, 3, 4], torch.from_numpy(k),
                       torch.from_numpy(k), start=0, n_new=5)


def _logits(seed, shape=(4, 32)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 3


@pytest.mark.parametrize("top_k", [1, 3, 7])
def test_temperature_sample_top_k_support_matches_jax(top_k):
    """Every token either package draws lies among the k largest logits,
    and over many draws both reach exactly that set."""
    logits = _logits(top_k)
    logits[0, :4] = logits[0, 0]  # a tie at the top: ties all kept
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy(logits).expand(400, -1, -1)
    ours = sampling.temperature_sample(t, temperature=2.0, top_k=top_k,
                                       generator=gen).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    theirs = np.stack([np.asarray(jsampling.temperature_sample(
        key, jnp.asarray(logits), temperature=2.0, top_k=top_k))
        for key in keys])
    assert ours.dtype == np.int32 and ours.shape == theirs.shape == (400, 4)
    for row in range(logits.shape[0]):
        kth = np.sort(logits[row])[-top_k]
        support = set(np.flatnonzero(logits[row] >= kth))
        assert set(ours[:, row]) == set(theirs[:, row]) == support, row


def test_temperature_sample_near_zero_temperature_is_greedy():
    logits = torch.from_numpy(_logits(5, (16, 50)))
    gen = torch.Generator().manual_seed(1)
    for temperature in (0.0, 1e-7):
        got = sampling.temperature_sample(logits, temperature,
                                          generator=gen)
        assert torch.equal(got, sampling.greedy(logits))
        want = jsampling.temperature_sample(jax.random.PRNGKey(3),
                                            jnp.asarray(logits.numpy()),
                                            temperature)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_sample_frequencies_match_softmax():
    """20,000 seeded draws of one row at temperature 0.7 with top-k 5:
    each token's frequency within 0.015 of the truncated softmax (over
    five standard errors at p = 0.5), as JAX's draws are."""
    logits = _logits(9, (12,))
    n, temperature, top_k = 20000, 0.7, 5
    x = logits / temperature
    kth = np.sort(x)[-top_k]
    p = np.where(x >= kth, np.exp(x - x.max()), 0.0)
    p /= p.sum()
    gen = torch.Generator().manual_seed(2)
    draws = sampling.temperature_sample(
        torch.from_numpy(logits).expand(n, -1), temperature, top_k,
        generator=gen).numpy()
    freq = np.bincount(draws, minlength=logits.size) / n
    np.testing.assert_allclose(freq, p, atol=0.015)
    jax_draws = np.asarray(jsampling.temperature_sample(
        jax.random.PRNGKey(4), jnp.broadcast_to(jnp.asarray(logits),
                                                (n, logits.size)),
        temperature, top_k))
    np.testing.assert_allclose(np.bincount(jax_draws, minlength=logits.size)
                               / n, p, atol=0.015)


@pytest.mark.parametrize("reduced", [False, True])
def test_all_configs_match_jax(reduced):
    """The same arch ids, every field equal (the dtype by name)."""
    from repro.configs import all_configs as jax_all
    from repro_torch.configs import all_configs
    ours, theirs = all_configs(reduced), jax_all(reduced)
    assert sorted(ours) == sorted(theirs)
    for arch, cfg in ours.items():
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(theirs[arch], f.name)
            if f.name == "dtype":
                got, want = str(got).split(".")[-1], jnp.dtype(want).name
            assert got == want, (arch, f.name)


def _documents():
    repo = pathlib.Path(__file__).resolve().parents[1]
    return repo, [repo / "README.md"] + sorted((repo / "docs").glob("*.md"))


@pytest.mark.parametrize("doc", [p.name for p in _documents()[1]])
def test_count_refs_matches_jax(doc):
    """``count_refs`` of README.md and each of docs/*.md, port and JAX
    pass, equal (and the repository's documents do name code)."""
    from repro.analysis.framework import SourceFile as JaxSourceFile
    from repro.analysis.passes.docs_refs import DocsRefsPass as JaxPass
    from repro_torch.analysis.framework import SourceFile
    from repro_torch.analysis.passes.docs_refs import DocsRefsPass
    repo, paths = _documents()
    path = next(p for p in paths if p.name == doc)
    ours = DocsRefsPass().count_refs(SourceFile(repo, path))
    assert ours == JaxPass().count_refs(JaxSourceFile(repo, path))
    if doc == "paper_map.md":
        assert ours > 0
