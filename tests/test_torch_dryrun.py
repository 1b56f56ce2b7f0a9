"""The port's scale-out: the collective recorder, the fake production mesh
and its teardown, the dry-run on a fake multi-pod mesh, the B5/B6
wrappers on DTensor shards, and the sharded steps on a real 4-process
gloo group against the unsharded port (``repro_torch.launch.mesh``,
``collectives``, ``dryrun``, ``kernels.ops.on_local_heads``).

Every process group is destroyed before its test returns (the fake ones
here; the gloo group lives in four child processes).  Tolerances: the
sharded train step's loss and every updated leaf, and the sharded
prefill's and decode steps' logits, within 1e-5 of the unsharded port's
(relative to each tensor's largest |value|: the sums run in another
order); the loss with the sequence-sharded residual stream within 1e-6
of the loss without; the local shards of B5/B6 on a fake mesh exactly
the plain versions' rows and heads.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from torch_port import shared_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_gloo_worker.py")


def test_collective_recorder_counts_and_bytes():
    """A hand-made sequence of functional collectives on a fake (4,) mesh:
    counts and per-device output bytes by kind, the reference's names, the
    total, and ``count_op`` over the local aten ops (the counterpart of
    ``test_collective_parser``)."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch import collectives as col
    from repro_torch.launch.mesh import fake_mesh
    with fake_mesh((4,), ("model",)) as mesh:
        group = mesh.get_group("model")
        x = torch.ones(8, 16)  # 512 bytes
        with col.CollectiveRecorder() as rec:
            funcol.all_gather_tensor(x, 0, group).wait()          # 2048
            funcol.all_reduce(x, "sum", group).wait()             # 512
            funcol.all_reduce(x, "sum", group).wait()             # 512
            funcol.reduce_scatter_tensor(x, "sum", 0, group).wait()  # 128
            funcol.all_to_all_single(x, None, None, group).wait()  # 512
            y = x @ x.T
        assert y.shape == (8, 8)
    assert not dist.is_initialized()
    got = rec.collectives()
    assert got == {"all-gather": (1, 2048), "all-reduce": (2, 1024),
                   "reduce-scatter": (1, 128), "all-to-all": (1, 512)}
    assert set(got) <= set(col.COLLECTIVES)
    assert col.total_collective_bytes(got) == 2048 + 1024 + 128 + 512
    assert col.count_op(rec, "mm") == 1
    assert col.count_op(rec, "all_reduce") == 2


def test_production_mesh_is_built_and_torn_down():
    """The (16, 16) and (2, 16, 16) meshes over fake groups of 256 and 512
    ranks, this process rank 0; after each, no group is left, and a real
    gloo group of one rank can be built (and is torn down)."""
    from repro_torch.launch import mesh as meshes
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16),
                                    ("pod", "data", "model"))):
        with meshes.production_mesh(multi_pod) as mesh:
            assert tuple(mesh.shape) == shape
            assert meshes.mesh_axis_sizes(mesh) == dict(zip(axes, shape))
            assert meshes.dp_axes(mesh) == axes[:-1]
            assert dist.get_world_size() == int(np.prod(shape))
            assert dist.get_rank() == 0
        assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mesh = meshes.make_mesh((1, 1), ("data", "model"), "cpu",
                            init_method=f"tcp://localhost:{port}")
    try:
        assert dist.get_backend() == "gloo" and mesh.size() == 1
    finally:
        meshes.teardown()
    assert not dist.is_initialized()


def test_dryrun_multipod_fake_mesh():
    """The counterpart of ``test_dryrun_multipod_sharding_in_subprocess``:
    the reduced llama's train step on a fake (2, 2, 2) mesh over
    ("pod", "data", "model") runs on fake shards (nothing allocated):
    FLOPs > 0, the gradients cross the pods (an all-reduce or a
    reduce-scatter), the record's roofline over the H100 SXM's datasheet
    figures, and the arguments' bytes those of the local shards."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    cfg = get_config("llama3.2-1b", reduced=True)
    with fake_mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
        rec = dryrun.run_one("llama3.2-1b", InputShape("tiny", 32, 8,
                                                       "train"),
                             True, None, mesh=mesh, cfg_override=cfg)
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    assert ("all-reduce" in rec["collectives"]
            or "reduce-scatter" in rec["collectives"])
    assert rec["n_chips"] == 8 and rec["mesh"] == {
        "pod": 2, "data": 2, "model": 2}
    assert "H100 SXM" in rec["hardware"] and "TPU" not in rec["hardware"]
    assert rec["dominant"] in rec["roofline"]
    assert rec["model_flops_per_device"] > 0 and rec["trace_s"] >= 0
    # the arguments: each parameter's and its two float32 moments' local
    # shards (the per-layer specs), the step counter and the token rows
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.sharding import MeshShape
    from repro_torch.models.registry import skeleton
    m = MeshShape(("pod", "data", "model"), (2, 2, 2))
    params = skeleton(cfg)
    specs = shr.param_specs(params, m, cfg)
    want = sum(shr.spec_bytes(p.shape, p.element_size() + 8, specs[n], m)
               for n, p in params.named_parameters())
    want += 4 + shr.spec_bytes((8, 32), 4, (("pod", "data"), None), m)
    assert rec["memory"]["argument_bytes"] == want


def test_b5_b6_take_shards_on_a_fake_mesh():
    """``ops.flash_prefill`` and ``ops.decode_attention`` on DTensors of a
    fake (2, 2) mesh (rows over "data", heads over "model"; a replicated
    input is chunked locally, so the shards hold real values): each
    rank-0 local output equals the plain versions' rows and heads of rank
    0; GQA heads that do not divide the model axis stay whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import fake_mesh
    rng = np.random.default_rng(0)
    B, T, D, W = 4, 8, 16, 12

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    pos[1, :3] = -1
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        for hq, hkv, head_shards in ((4, 2, 2), (4, 1, 1)):
            q, k, v = t(B, T, hq, D), t(B, T, hkv, D), t(B, T, hkv, D)
            rep = [Replicate(), Replicate()]
            dq, dk, dv, dp = (DTensor.from_local(x, mesh, rep)
                              for x in (q, k, v, pos))
            want = ref.flash_prefill_ref(q, k, v, pos)
            got = ops.flash_prefill(dq, dk, dv, dp)
            assert got.placements[0] == Shard(0)
            assert got.placements[1] == (Shard(2) if head_shards > 1
                                         else Replicate())
            hl = hq // head_shards
            torch.testing.assert_close(got.to_local(),
                                       want[:B // 2, :, :hl], rtol=0, atol=0)
            qd, kc, vc = t(B, hq, D), t(B, W, hkv, D), t(B, W, hkv, D)
            slot_pos = torch.arange(W, dtype=torch.int32)[None].repeat(B, 1)
            slot_pos[0, 9:] = -1
            q_pos = torch.full((B,), W - 1, dtype=torch.int32)
            want = ref.decode_attention_ref(qd, kc, vc, slot_pos, q_pos,
                                            window=6)
            got = ops.decode_attention(
                *(DTensor.from_local(x, mesh, rep)
                  for x in (qd, kc, vc, slot_pos, q_pos)), window=6)
            torch.testing.assert_close(got.to_local(),
                                       want[:B // 2, :hl], rtol=0, atol=0)
    assert not dist.is_initialized()


def test_sharded_steps_on_four_gloo_ranks(tmp_path):
    """Four processes, a real gloo group, a (2, 2) mesh over ("data",
    "model"), the weights carried from the JAX initialisation
    (``params_from_jax``): the sharded train step of the reduced llama
    (loss and every updated leaf), its loss with the residual stream
    sequence-sharded, and the sharded prefill and two decode steps of the
    reduced llama and Mamba-2 all match the unsharded port."""
    for arch, name in (("llama3.2-1b", "llama.pt"),
                       ("mamba2-130m", "mamba.pt")):
        _, _, _, tp = shared_models(arch)
        torch.save(tp.state_dict(), tmp_path / name)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "4",
                               str(port), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, outs[r][-3000:]
    for r in range(4):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        tr = res["train"]
        assert abs(tr["loss"] - tr["ref_loss"]) <= 1e-5 * abs(tr["ref_loss"])
        assert tr["leaf_gap"] <= 1e-5
        assert tr["seq_shard_gap"] <= 1e-6 * abs(tr["ref_loss"])
        # 2 layers over a "data" axis of 2: FSDP's layer axis, moved onto
        # each layer's first dim
        assert tr["sharded_placements"] == "(Shard(dim=0), Replicate())"
        for fam, kernel in (("llama", "flash_prefill"),
                            ("mamba", "ssd_scan")):
            assert max(res[fam]["gaps"]) <= 1e-5, (fam, res[fam]["gaps"])
            assert res[fam]["plain_calls"][kernel] > 0
        assert res["llama"]["plain_calls"]["decode_attention"] == 4
