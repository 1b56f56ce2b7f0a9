"""``chip_smoke.py``'s phase-10 helpers on the CPU: the recorder of the
paged engines' decode steps (``StepRecorder``) on the reduced float32
llama3.2-1b's paged ILS engine and persistent paged engine, and the live
pool slots that the paged decode kernels' bounds count
(``paged_shape``)."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engine():
    from repro_torch.configs import get_config
    from repro_torch.engine.continuous_engine import ContinuousEngine
    from repro_torch.models.registry import get_model
    model = get_model(get_config("llama3.2-1b", reduced=True))
    params = model.init(0, device="cpu")
    return ContinuousEngine(model, params, max_context=64, eos_id=1,
                            len_bucket=8, device="cpu", max_slots=4,
                            kv_layout="paged", page_tokens=8,
                            total_kv_tokens=4 * 64)


@pytest.mark.parametrize("n_steps_cut", [None, 1])
def test_step_recorder_keeps_each_decode_step(smoke, engine, n_steps_cut):
    """One record per decode iteration (read from the engine's step
    buffers after the step: ``graphs.Step.__call__`` wrapped), the new
    token's slot marked with its position, the step and the loop restored
    on exit; ``typical`` returns the upper-median step by live slots.
    With no config nothing is recorded."""
    from repro_torch.engine import graphs
    orig = graphs.Step.__call__
    orig_loop = graphs.Loop.__call__
    cfg = engine.cfg
    rng = np.random.default_rng(0)
    ps = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
          for n in (10, 20, 5, 30, 12)]
    engine.n_decode_steps = 0
    with smoke.StepRecorder(cfg if n_steps_cut is None else None) as rec:
        assert graphs.Step.__call__ is not orig
        engine.serve(ps, forced_gen_lens=[6, 9, 4, 12, 3], max_gen=16)
    assert graphs.Step.__call__ is orig
    assert graphs.Loop.__call__ is orig_loop
    assert engine.n_decode_steps > 0
    if n_steps_cut is not None:
        assert rec.steps == []
        with pytest.raises(SystemExit):
            rec.typical()
        return
    assert len(rec.steps) == engine.n_decode_steps
    for st in rec.steps:
        marked = st["slot_pos"].gather(1, st["slots"].long()[:, None])[:, 0]
        assert torch.equal(marked, st["q_pos"])
        assert st["pool"][1:] == (8, cfg.n_kv_heads, cfg.head_dim)
    live = [int((st["slot_pos"] >= 0).sum()) for st in rec.steps]
    got = rec.typical()
    assert got["stats"]["live_slots"] == sorted(live)[len(live) // 2]
    assert got["stats"]["steps"] == len(live)
    assert got["stats"]["mean_live_slots"] == pytest.approx(np.mean(live))
    assert torch.equal(got["bt"], rec.steps[got["stats"]["step"]]["bt"])


def test_step_recorder_reads_the_static_engines_steps(smoke, engine):
    """The persistent paged ``StaticEngine``'s steps are recorded too,
    rebuilt from its loop's static buffers after the slice's one loop
    call: one a decode iteration, each row's new slot marked with its
    position (rows' lengths plus the step just run, the compact layout),
    pad rows on the null page; the eager loop's pools and tokens are the
    same as what the recorded steps describe."""
    from repro_torch.engine.static_engine import StaticEngine
    cfg = engine.cfg
    eng = StaticEngine(engine.model, engine.params, eos_id=1, len_bucket=8,
                       kv_layout="paged", page_tokens=8, kv_pool_tokens=256,
                       device="cpu")
    rng = np.random.default_rng(1)
    ps = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
          for n in (10, 20, 5)]
    with smoke.StepRecorder(cfg) as rec:
        res = eng.serve_batch_paged(ps, 4, [0, 1, 2], forced_gen_lens=[4] * 3)
    assert len(rec.steps) == res.steps == eng.n_decode_steps == 4
    final = eng.step_graphs.get(("paged", "unfused", 4, 4, 4)).bufs["cache"]
    for j, st in enumerate(rec.steps):
        assert st["q_pos"][:3].tolist() == [n + j for n in (10, 20, 5)]
        marked = st["slot_pos"].gather(1, st["slots"].long()[:, None])[:, 0]
        assert torch.equal(marked, st["q_pos"])
        assert st["bt"][3].tolist() == [0] * st["bt"].shape[1]
        assert int((st["slot_pos"] >= 0).sum()) == 35 + 4 * (j + 1)
    # the last step's slot_pos is the one the loop left in its buffers
    assert torch.equal(rec.steps[-1]["slot_pos"], final.slot_pos)


def test_paged_shape_counts_distinct_live_pool_rows(smoke):
    """Two idle rows that attend the null page's slot 0 count it once; the
    fused call leaves out the rows it appends (their K/V come in as
    k/v_new)."""
    pg, Hkv, D = 8, 2, 32
    k_pages = torch.zeros((6, pg, Hkv, D))
    bt = torch.tensor([[1, 2, 0], [3, 0, 0], [0, 0, 0], [0, 0, 0]],
                      dtype=torch.int32)
    slot_pos = torch.full((4, 3 * pg), -1, dtype=torch.int32)
    slot_pos[0, 2:12] = torch.arange(10)     # 10 live, pages 1 and 2
    slot_pos[1, :5] = torch.arange(5)        # 5 live, page 3
    slot_pos[2:, 0] = 0                      # idle rows: the null slot
    q = torch.zeros((4, 8, D))
    shape = smoke.paged_shape(q, k_pages, bt, slot_pos)
    assert shape["n_valid_tokens"] == 10 + 5 + 1
    assert (shape["B"], shape["nb"], shape["null_rows"]) == (4, 3, 2)
    slots = torch.tensor([11, 4, 0, 0], dtype=torch.int32)
    fused = smoke.paged_shape(q, k_pages, bt, slot_pos, slots=slots)
    assert fused["n_valid_tokens"] == 9 + 4
    assert smoke.appended_rows(bt, slots, pg).tolist() == [2 * pg + 3,
                                                           3 * pg + 4, 0, 0]


def test_stage_recorder_keeps_each_mamba_prefill_stage(smoke):
    """One record per prefill stage of the reduced float32 mamba2-130m's
    dense engine, rebuilt from its loop's static inputs: rows,
    chunk-padded tokens and each row's valid tokens, the prompt's own
    length on the first slice and prompt + generated on the re-prefill,
    batch-bucket pad rows the one pad token the engine gives them; each
    the scan's own shape (its first layer's, seen through the ops'
    wrapper); the loop restored on exit.  ``timed_stages`` picks the upper
    median by rows x tokens and the largest."""
    from repro_torch.configs import get_config
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    model = get_model(get_config("mamba2-130m", reduced=True))
    params = model.init(0, device="cpu")
    engine = StaticEngine(model, params, device="cpu", eos_id=1,
                          len_bucket=8)
    rng = np.random.default_rng(3)
    lens = [5, 23, 9]
    ps = [rng.integers(2, model.cfg.vocab_size, size=n).astype(np.int32)
          for n in lens]
    from repro_torch.engine import graphs
    orig, scan = graphs.Loop.__call__, ops.ssd_chunked_scan
    seen = []

    def watched(x, dt, *a, **kw):
        seen.append(dict(B=x.shape[0], T=x.shape[1],
                         lengths=(dt != 0).any(-1).sum(1).tolist()))
        return scan(x, dt, *a, **kw)

    engine.n_prefill_stages = 0
    ops.ssd_chunked_scan = watched
    try:
        with smoke.StageRecorder(model.cfg.ssm_chunk) as rec:
            assert graphs.Loop.__call__ is not orig
            first = engine.serve_batch(ps, 4, forced_gen_lens=[6, 6, 6])
            gen = [r["tokens"] for r in first.results]
            engine.serve_batch(ps[:2], 4, forced_gen_lens=[2, 2],
                               already_generated=gen[:2])
    finally:
        ops.ssd_chunked_scan = scan
    assert graphs.Loop.__call__ is orig
    assert len(rec.stages) == engine.n_prefill_stages == 2
    assert [{k: st[k] for k in ("B", "T", "lengths")} for st in rec.stages] \
        == seen[::model.cfg.n_layers]
    Q = model.cfg.ssm_chunk
    for st in rec.stages:
        assert st["T"] % Q == 0 and st["chunk"] == Q
        assert len(st["lengths"]) == st["B"]
        assert all(isinstance(n, int) for n in st["lengths"])
    a, b = rec.stages
    assert a["B"] == 4 and b["B"] == 2
    assert sorted(a["lengths"]) == sorted(lens + [1])
    assert sorted(b["lengths"]) == sorted(
        n + len(g) for n, g in zip(lens[:2], gen[:2]))
    picked = smoke.timed_stages(rec.stages + [dict(B=1, T=Q, lengths=[3])])
    sizes = sorted(st["B"] * st["T"] for st in rec.stages) + [Q]
    (m_label, m_st, m_stats), (l_label, l_st, _) = picked
    assert m_st["B"] * m_st["T"] == sorted(sizes)[len(sizes) // 2]
    assert l_st["B"] * l_st["T"] == max(sizes)
    assert m_label.startswith("median stage") and l_label.startswith(
        "largest stage")
    assert m_stats["stages"] == 3
    with pytest.raises(SystemExit):
        smoke.timed_stages([])


@pytest.mark.parametrize("impl", ["unfused", "fused"])
def test_prefill_recorder_keeps_each_paged_prefill_stage(smoke, impl):
    """One record per prefill stage of the reduced float32 llama3.2-1b's
    paged ``StaticEngine``, rebuilt from its prefill's static buffers: a
    fresh prompt, then in one call a resumed resident, a fresh stage A and
    a stage-A' tail past two shared pages, each through its ``impl``'s
    write; positions and block table as the engine passed them to the
    first layer's write, the tail marked; the prefill restored on exit.  ``timed_writes`` picks the upper median by
    valid tokens and the largest, the stages phase 12 times."""
    from repro_torch.configs import get_config
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    model = get_model(get_config("llama3.2-1b", reduced=True))
    params = model.init(0, device="cpu")
    engine = StaticEngine(model, params, device="cpu", eos_id=1,
                          len_bucket=8, kv_layout="paged", page_tokens=8,
                          kv_pool_tokens=512, attn_impl=impl)
    rng = np.random.default_rng(9)
    src, tail, fresh = (rng.integers(2, model.cfg.vocab_size, size=n)
                        .astype(np.int32) for n in (21, 7, 11))
    joiner = np.concatenate([src[:16], tail])
    from repro_torch.engine import graphs
    orig = graphs.Prefill.__call__
    name = "fused_rope_prefill_write" if impl == "fused" else \
        "paged_prefill_write"
    write, seen = getattr(ops, name), []

    def watched(k_new, v_new, positions, block_table, *a, **kw):
        seen.append((positions.clone(), block_table.clone()))
        return write(k_new, v_new, positions, block_table, *a, **kw)

    engine.n_prefill_stages = engine.n_tail_prefill_stages = 0
    setattr(ops, name, watched)
    try:
        with smoke.PrefillRecorder() as rec:
            assert graphs.Prefill.__call__ is not orig
            first = engine.serve_batch_paged([src], 8, [1],
                                             forced_gen_lens=[24])
            engine.serve_batch_paged(
                [src, joiner, fresh], 8, [1, 2, 3],
                forced_gen_lens=[16, 12, 12],
                already_generated=[first.results[0]["tokens"], [], []])
    finally:
        setattr(ops, name, write)
    assert graphs.Prefill.__call__ is orig
    assert len(rec.stages) == engine.n_prefill_stages == 3
    # each stage's rebuilt inputs are the ones its first layer's write got
    for st, (pos, bt) in zip(rec.stages, seen[::model.cfg.n_layers]):
        assert torch.equal(st["positions"], pos)
        assert torch.equal(st["bt"], bt)
    assert engine.n_tail_prefill_stages == 1
    assert all(st["kernel"] == name for st in rec.stages)
    assert sorted(st["valid"] for st in rec.stages) == [7, 11, 21]
    for st in rec.stages:
        pos = st["positions"]
        assert (st["B"], st["T"]) == tuple(pos.shape)
        assert st["bt"].shape[0] == st["B"] and st["bt"].dtype == torch.int32
        assert st["pool"][1:] == (8, model.cfg.n_kv_heads,
                                  model.cfg.head_dim)
        assert st["tail"] == (st["valid"] == 7)
        if st["tail"]:
            assert pos[pos >= 0].tolist() == list(range(16, 23))
    picked = smoke.timed_writes(rec.stages)
    (m_label, m_st, m_stats), (l_label, l_st, l_stats) = picked
    assert (m_st["valid"], l_st["valid"]) == (11, 21)
    assert m_label.startswith("median stage") and l_label.startswith(
        "largest stage")
    assert m_stats["stages"] == 3 and m_stats["tail_stages"] == 1
    assert smoke.recorded_writes("x", rec, dict(prefill_stages=3)) \
        is rec.stages
    with pytest.raises(SystemExit):
        smoke.recorded_writes("x", rec, dict(prefill_stages=4))
    with pytest.raises(SystemExit):
        smoke.timed_writes([])
    for rid in (1, 2, 3):
        engine.release_request(rid)


def test_write_smoke_indices_follow_the_phase_3_batch(smoke):
    """``WRITE_SMOKE``'s positions and block table (on the CPU here): rows
    left-padded to T at their own lengths, the tail row from position 32,
    3,755 valid tokens; each row's pages distinct; the bound counts each
    valid K/V row read and written once."""
    _, lengths, starts, T = smoke.WRITE_SMOKE
    gen = torch.Generator()
    gen.manual_seed(0)
    positions, bt = smoke.smoke_write_indices(1000, 16, gen, device="cpu")
    assert positions.shape == (len(lengths), T)
    assert int((positions >= 0).sum()) == sum(lengths) == 3755
    for row, n, s in zip(positions.tolist(), lengths, starts):
        assert row[:T - n] == [-1] * (T - n)
        assert row[T - n:] == list(range(s, s + n))
    assert bt.shape == (len(lengths), 34) and len(set(bt.flatten().tolist())) \
        == bt.numel()
    b_ms, b_by, n_valid = smoke.write_bound(positions, 8, 64, 2, False)
    assert (b_by, n_valid) == ("bytes", 3755)
    n_bytes = 4 * 3755 * 8 * 64 * 2 + positions.numel() * 4 + 3755 * 4
    assert b_ms == pytest.approx(n_bytes / smoke.HBM_BYTES_PER_S * 1e3)
