"""One rank of ``tests/test_torch_dryrun.py``'s gloo test (not a test
module): run the reduced float32 port unsharded and on a (2, 2) DTensor
mesh over a real gloo group, and write what it measured to
``<out>/rank<r>.json``.

  python torch_gloo_worker.py RANK WORLD PORT OUT_DIR

``OUT_DIR`` holds the weights (``llama.pt``, ``mamba.pt``: the port's
state dicts, carried from the JAX initialisation by the parent).  The
comparisons: a train step (the loss and every updated leaf), the loss
with and without the sequence-sharded residual stream, and a prefill and
two decode steps of the dense model and of Mamba-2 (logits).
"""
import json
import os
import sys

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication


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


def serve(out, mesh, shr, arch, weights):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.registry import get_model
    cfg = get_config(arch, reduced=True)
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
    want = run(ref, {"tokens": tokens, "lengths": lengths}, False)
    params = model.init(0, device="cpu")
    params.load_state_dict(state)
    shr.shard_params(params, shr.param_specs(params, mesh, cfg), mesh)
    batch = _place_batch(shr, {"tokens": tokens, "lengths": lengths},
                         mesh, B)
    ops.reset_counts()
    with implicit_replication():
        got = run(params, batch, True)
    return dict(gaps=[_gap(g, w) for g, w in zip(got, want)],
                plain_calls=dict(ops.plain_calls))


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
                   mamba=serve(out, mesh, shr, "mamba2-130m", "mamba.pt"))
    finally:
        meshes.teardown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
