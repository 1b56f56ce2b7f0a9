"""Set-up shared by the port's tests (``tests/test_torch_*.py``): the
reduced llama3.2-1b on both sides, the port's weights carried over from
the JAX initialisation, and inputs made with numpy from a seed."""
import functools

import jax
import numpy as np


@functools.lru_cache(maxsize=None)
def shared_models():
    """(jax_model, jax_params, torch_model, torch_params) of the reduced
    float32 llama3.2-1b, with the JAX ``init(PRNGKey(0))`` weights loaded
    into the port's module on the CPU."""
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro_torch.configs import get_config as torch_config
    from repro_torch.models.registry import get_model as torch_model
    from repro_torch.weights import params_from_jax
    jm = jax_model(jax_config("llama3.2-1b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_model(torch_config("llama3.2-1b", reduced=True))
    tp = tm.init(0, device="cpu")
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm, tp


def prompts(vocab, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=s).astype(np.int32) for s in sizes]


#: two greedy streams may part only where the reference's top-2 logits lie
#: closer than this (float32 sums taken in another order can flip them)
NEAR_TIE = 1e-4

#: near-ties met by ``assert_same_stream``: (prompt length, token index, gap)
near_ties = []


def assert_same_stream(prompt, want, got):
    """``got`` equals the JAX stream ``want`` token for token, or parts from
    it only at a near-tie: there the JAX model's top-2 logits for that token
    (prefill of prompt + want[:j]) lie within ``NEAR_TIE``; the tie is
    recorded in ``near_ties`` and the rest of the stream, now conditioned
    on another token, is not compared."""
    want, got = list(want), list(got)
    for j, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        jm, jp, _, _ = shared_models()
        ctx = np.concatenate([np.asarray(prompt, np.int32),
                              np.asarray(want[:j], np.int32)])
        logits, _ = jm.prefill(jp, {"tokens": ctx[None],
                                    "lengths": np.array([len(ctx)],
                                                        np.int32)},
                               len(ctx) + 1)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        gap = float(top2[1] - top2[0])
        assert gap < NEAR_TIE, (f"token {j}: port {b} != JAX {a}, top-2 "
                                f"logit gap {gap:.2e} is no near-tie")
        near_ties.append((len(prompt), j, gap))
        return
    assert len(want) == len(got), (len(want), len(got))
