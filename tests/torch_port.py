"""Set-up shared by the port's tests (``tests/test_torch_*.py``): a
reduced model on both sides (llama3.2-1b by default, or any arch of
``repro_torch.configs``), the port's weights carried over from the JAX
initialisation, and inputs made with numpy from a seed."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.testing import stream_tie


def _perturb_ssm(tree, seed=7):
    """JAX's Mamba-2 init makes every head alike (A_log 0, dt_bias 0, D 1,
    conv_b 0), which would hide a wrong head or group index: give each
    head and channel its own values, in the tree both sides load."""
    rng = np.random.default_rng(seed)
    mixer = tree["layers"]["mixer"]
    for name, loc, scale in (("A_log", 0.0, 0.5), ("dt_bias", 0.0, 0.5),
                             ("D", 1.0, 0.5), ("conv_b", 0.0, 0.2)):
        leaf = mixer[name]
        mixer[name] = (loc + scale * rng.standard_normal(leaf.shape)
                       ).astype(leaf.dtype)
    return tree


def _perturb_bias(tree, seed=8):
    """JAX's init makes the QKV biases zero (``dense_param``), so a bias
    left out would pass unseen: give each its own values, in the tree both
    sides load."""
    rng = np.random.default_rng(seed)
    attn = tree["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        leaf = attn[name]["b"]
        attn[name]["b"] = (0.5 * rng.standard_normal(leaf.shape)
                           ).astype(leaf.dtype)
    return tree


def _perturb_rglru(tree, seed=9):
    """JAX's RG-LRU init makes every channel alike (``lambda`` 1, conv_b
    0), which would hide a wrong channel index: give each channel its own
    values (lambda in [0.1, 2.1], so that a ∈ (e^{-8·2.2}, 1) spans slow
    and fast channels), in the tree both sides load."""
    rng = np.random.default_rng(seed)
    blocks = [tree["groups"]["rec"]] + ([tree["tail"]] if "tail" in tree
                                        else [])
    for blk in blocks:
        blk["lambda"] = (0.1 + 2.0 * rng.random(blk["lambda"].shape)
                         ).astype(blk["lambda"].dtype)
        blk["conv_b"] = (0.2 * rng.standard_normal(blk["conv_b"].shape)
                         ).astype(blk["conv_b"].dtype)
    return tree


def _perturb_norms(tree, seed=10):
    """JAX's ``init_rms`` is zero, so every norm gain of the
    encoder-decoder starts alike and a swapped ``ln_self``, ``ln_cross``
    or ``ln_enc`` would pass unseen: give each gain its own values, in the
    tree both sides load."""
    rng = np.random.default_rng(seed)
    stacks = ((tree["enc_layers"], ("ln_attn", "ln_mlp")),
              (tree["dec_layers"], ("ln_self", "ln_cross", "ln_mlp")),
              (tree, ("ln_enc", "ln_f")))
    for node, names in stacks:
        for name in names:
            node[name] = (0.3 * rng.standard_normal(node[name].shape)
                          ).astype(node[name].dtype)
    return tree


@functools.lru_cache(maxsize=None)
def shared_models(arch="llama3.2-1b", head_dim=None, capacity_factor=None,
                  heads=None):
    """(jax_model, jax_params, torch_model, torch_params) of the reduced
    float32 ``arch`` (its ``head_dim``, MoE ``capacity_factor`` or
    ``heads`` = (n_heads, n_kv_heads, head_dim) replaced where given, on
    both sides), with the JAX ``init(PRNGKey(0))`` weights
    loaded into the port's module on the CPU (for mamba2-130m with the
    per-head parameters, for recurrentgemma-9b with the per-channel RG-LRU
    parameters, for a config with QKV biases with the biases, for the
    encoder-decoder with the norm gains, drawn apart on both sides)."""
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro_torch.configs import get_config as torch_config
    from repro_torch.models.registry import get_model as torch_model
    from repro_torch.weights import params_from_jax
    jcfg, tcfg = jax_config(arch, reduced=True), torch_config(arch,
                                                              reduced=True)
    if head_dim is not None:
        jcfg, tcfg = (c.replace(head_dim=head_dim) for c in (jcfg, tcfg))
    if capacity_factor is not None:
        jcfg, tcfg = (c.replace(capacity_factor=capacity_factor)
                      for c in (jcfg, tcfg))
    if heads is not None:
        jcfg, tcfg = (c.replace(n_heads=heads[0], n_kv_heads=heads[1],
                                head_dim=heads[2]) for c in (jcfg, tcfg))
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    perturb = {"ssm": _perturb_ssm, "hybrid": _perturb_rglru,
               "encdec": _perturb_norms}.get(
        jm.cfg.family, _perturb_bias if jm.cfg.qkv_bias else None)
    if perturb is not None:
        tree = perturb(tree)
        jp = jax.tree.map(jax.numpy.asarray, tree)
    tm = torch_model(tcfg)
    tp = tm.init(0, device="cpu")
    tp.load_state_dict(params_from_jax(tree))
    return jm, jp, tm, tp


def prompts(vocab, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=s).astype(np.int32) for s in sizes]


#: near-ties met by ``assert_same_stream``: (arch, prompt length, gap)
near_ties = []


def assert_same_stream(prompt, want, got, arch="llama3.2-1b", **variant):
    """``got`` equals the JAX stream ``want`` token for token, or parts from
    it only at a near-tie (``repro_torch.testing.stream_tie`` with the JAX
    model's prefill as the reference); the tie is recorded in
    ``near_ties`` and the rest of the stream is not compared."""
    jm, jp, _, _ = shared_models(arch, **variant)

    def jax_logits(ctx):
        logits, _ = jm.prefill(jp, {"tokens": ctx[None],
                                    "lengths": np.array([len(ctx)],
                                                        np.int32)},
                               len(ctx) + 1)
        return np.asarray(logits[0])

    gap = stream_tie(jax_logits, prompt, want, got)
    if gap is not None:
        near_ties.append((arch, len(prompt), gap))


def check_config_fields(arch, reduced):
    """Every field the port's config of ``arch`` has equals the JAX
    config's, the dtype by name (the port keeps its own copy of each
    config)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config as torch_config
    tcfg, jcfg = torch_config(arch, reduced), jax_config(arch, reduced)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            got, want = str(got).split(".")[-1], jnp.dtype(want).name
        assert got == want, f.name


def serve_slices(models, ps, extra, forced, slice_len=4, n_slices=3):
    """SCLS over ``n_slices`` slices of ``slice_len`` on the JAX and the
    port's dense ``StaticEngine`` (``models`` from ``shared_models``):
    each slice batches the unfinished requests, builds an engine over
    their rows of the frontend inputs ``extra`` (name: array with a row
    per request) and re-prefills prompt + generated.  Returns each side's
    streams and each slice's ``reprefill_tokens``, keyed "jax" and
    "torch"."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    outs = {"jax": [[] for _ in ps], "torch": [[] for _ in ps]}
    reprefill = {"jax": [], "torch": []}
    for _ in range(n_slices):
        idx = [i for i in range(len(ps)) if len(outs["jax"][i]) < forced[i]]
        if not idx:
            break
        rows = {k: v[idx] for k, v in extra.items()}
        for side, eng in (("jax", JaxEngine(jm, jp, eos_id=1, len_bucket=8,
                                            extra_inputs=rows)),
                          ("torch", StaticEngine(tm, tp, eos_id=1,
                                                 len_bucket=8,
                                                 extra_inputs=rows,
                                                 device="cpu"))):
            res = eng.serve_batch(
                [ps[i] for i in idx], slice_len,
                forced_gen_lens=[forced[i] - len(outs[side][i]) for i in idx],
                already_generated=[outs[side][i] for i in idx])
            for s, i in enumerate(idx):
                outs[side][i] = outs[side][i] + res.results[s]["tokens"]
            reprefill[side].append(res.reprefill_tokens)
    return outs, reprefill
