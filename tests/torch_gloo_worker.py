"""One rank of ``tests/test_torch_dryrun.py``'s gloo test (not a test
module): run the reduced float32 port unsharded and on a (2, 2) DTensor
mesh over a real gloo group, and write what it measured to
``<out>/rank<r>.json``.

  python torch_gloo_worker.py RANK WORLD PORT OUT_DIR

``OUT_DIR`` holds the weights (``llama.pt``, ``mamba.pt``, ``mixtral.pt``,
``deepseek.pt``: the port's state dicts, carried from the JAX
initialisation by the parent; the MoE models at capacity factor
``MOE_CAPACITY``).  The comparisons: a train step (the loss and every
updated leaf), the loss with and without the sequence-sharded residual
stream, a prefill and two decode steps of the dense model, of Mamba-2
and of both MoE models (logits), and each MoE model's first MoE layer
alone with its load-balance term, at a decode-sized and a long stream
(``MOE_LAYER_SHAPES``).  The MoE runs also count the choices the
unsharded port drops.
"""
import contextlib
import json
import os
import sys

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

#: the MoE models' capacity factor, at which the unsharded port drops
#: choices (the reduced configs' 4.0 drops none)
MOE_CAPACITY = 1.0
#: (B, T) of the lone MoE layer: every rank routes the gathered stream
#: (8 tokens), then each "data" rank's rows are one global group of 1,024
#: (deepseek's experts shard over "model" only, so it routes them alone)
MOE_LAYER_SHAPES = ((4, 2), (4, 512))


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _gap(a, b) -> float:
    """Largest |a - b| relative to b's largest |value|."""
    a, b = _full(a).detach().float(), _full(b).detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _batch(cfg, B, T, seed):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(2, cfg.vocab_size, (B, T), generator=g,
                           dtype=torch.int32)
    lengths = torch.tensor([T, T - 3, T - 1, T - 5][:B], dtype=torch.int32)
    return tokens, lengths


def _place_batch(shr, batch, mesh, B):
    return shr.named(batch, shr.batch_spec(batch, mesh, B), mesh)


def train(out, mesh, shr):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import set_activation_sharding
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    cfg = get_config("llama3.2-1b", reduced=True)
    model = get_model(cfg)
    state = torch.load(os.path.join(out, "llama.pt"))
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3,
                                eps=1e-3)
    step = make_train_step(model, opt_cfg)
    tokens, _ = _batch(cfg, 4, 16, 1)
    ref = model.init(0, device="cpu")
    ref.load_state_dict(state)
    ref, _, ref_loss = step(ref, adamw.init_adamw(ref), {"tokens": tokens})

    params = model.init(0, device="cpu")
    params.load_state_dict(state)
    opt = adamw.init_adamw(params)
    shr.shard_params(params, shr.param_specs(params, mesh, cfg), mesh)
    ospecs = shr.opt_state_specs(opt, params, mesh, cfg)
    opt = adamw.AdamWState(step=opt.step,
                           mu=shr.named(opt.mu, ospecs.mu, mesh),
                           nu=shr.named(opt.nu, ospecs.nu, mesh))
    batch = _place_batch(shr, {"tokens": tokens}, mesh, 4)
    with implicit_replication():
        loss_plain = model.loss(params, batch)
        set_activation_sharding(shr.placements((("data",), "model", None),
                                               mesh))
        try:
            loss_seq = model.loss(params, batch)
        finally:
            set_activation_sharding(None)
        params, opt, loss = step(params, opt, batch)
    ref_p = dict(ref.named_parameters())
    leaf = max(_gap(p, ref_p[n]) for n, p in params.named_parameters())
    return dict(loss=float(_full(loss)), ref_loss=float(ref_loss),
                leaf_gap=leaf,
                seq_shard_gap=abs(float(_full(loss_seq))
                                  - float(_full(loss_plain))),
                sharded_placements=str(
                    dict(params.named_parameters())[
                        "layers.0.attn.wq.w"].placements))


@contextlib.contextmanager
def _counting_drops(counts):
    """Add each routing's dropped choices to ``counts["dropped"]``."""
    from repro_torch.models import moe
    dispatch = moe._dispatch

    def counted(probs, k, cap):
        r = dispatch(probs, k, cap)
        counts["dropped"] += int((~r.keep).sum())
        return r

    moe._dispatch = counted
    try:
        yield
    finally:
        moe._dispatch = dispatch


def moe_layer(cfg, ref, params, mesh, shr):
    """The first MoE layer alone, unsharded and on the mesh (x's rows
    over "data"), at each of ``MOE_LAYER_SHAPES``: the output's and the
    load-balance term's gaps, and the choices the unsharded layer drops."""
    from repro_torch.models.moe import moe_apply
    g = torch.Generator().manual_seed(3)
    out = dict(gaps=[], aux_gaps=[], dropped=[])
    for B, T in MOE_LAYER_SHAPES:
        x = torch.randn((B, T, cfg.d_model), generator=g)
        counts = dict(dropped=0)
        with _counting_drops(counts):
            want, want_aux = moe_apply(ref.layers[0].moe, x, cfg,
                                       with_aux=True)
        xd = shr.place(x, (("data",), None, None), mesh)
        with implicit_replication():
            got, aux = moe_apply(params.layers[0].moe, xd, cfg,
                                 with_aux=True)
        out["gaps"].append(_gap(got, want))
        out["aux_gaps"].append(abs(float(_full(aux)) - float(want_aux)))
        out["dropped"].append(counts["dropped"])
    return out


def serve(out, mesh, shr, arch, weights):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.registry import get_model
    cfg = get_config(arch, reduced=True)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=MOE_CAPACITY)
    model = get_model(cfg)
    state = torch.load(os.path.join(out, weights))
    B, T, W = 4, 8, 16
    tokens, lengths = _batch(cfg, B, T, 2)
    prefill = make_prefill_step(model, W)
    decode = make_decode_step(model)

    def run(params, batch, place_cache):
        logits, cache = prefill(params, batch)
        if place_cache:
            cache = shr.named(cache, shr.cache_spec(cache, mesh, cfg, B),
                              mesh)
        outs = [logits]
        tok = logits.argmax(-1).to(torch.int32)
        for s in range(2):
            logits, cache = decode(params, cache, tok, s)
            outs.append(logits)
            tok = logits.argmax(-1).to(torch.int32)
        return outs

    ref = model.init(0, device="cpu")
    ref.load_state_dict(state)
    counts = dict(dropped=0)
    with _counting_drops(counts):
        want = run(ref, {"tokens": tokens, "lengths": lengths}, False)
    params = model.init(0, device="cpu")
    params.load_state_dict(state)
    shr.shard_params(params, shr.param_specs(params, mesh, cfg), mesh)
    batch = _place_batch(shr, {"tokens": tokens, "lengths": lengths},
                         mesh, B)
    ops.reset_counts()
    with implicit_replication():
        got = run(params, batch, True)
    res = dict(gaps=[_gap(g, w) for g, w in zip(got, want)],
               plain_calls=dict(ops.plain_calls), dropped=counts["dropped"])
    if cfg.family == "moe":
        res["layer"] = moe_layer(cfg, ref, params, mesh, shr)
        res["expert_placements"] = str(
            params.layers[0].moe.experts.up.w.placements)
    return res


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.manual_seed(0)
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import sharding as shr
    mesh = meshes.make_mesh((2, 2), ("data", "model"), "cpu",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank)
    try:
        res = dict(train=train(out, mesh, shr),
                   llama=serve(out, mesh, shr, "llama3.2-1b", "llama.pt"),
                   mamba=serve(out, mesh, shr, "mamba2-130m", "mamba.pt"),
                   mixtral=serve(out, mesh, shr, "mixtral-8x22b",
                                 "mixtral.pt"),
                   deepseek=serve(out, mesh, shr, "deepseek-v2-lite-16b",
                                  "deepseek.pt"))
    finally:
        meshes.teardown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
