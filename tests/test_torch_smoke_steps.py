"""``chip_smoke.py``'s phase-10 helpers on the CPU: the recorder of the
paged engines' decode steps (``StepRecorder``) on the reduced float32
llama3.2-1b's paged ILS engine, and the live pool slots that the paged
decode kernels' bounds count (``paged_shape``)."""
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
    """One record per decode iteration (the first layer's call), the new
    token's slot marked with its position, the model's attention restored
    on exit; ``typical`` returns the upper-median step by live slots.
    With ``n_layers`` 0 nothing is recorded."""
    from repro_torch.models import attention
    orig = attention.attention_decode_paged
    cfg = engine.cfg
    rng = np.random.default_rng(0)
    ps = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
          for n in (10, 20, 5, 30, 12)]
    engine.n_decode_steps = 0
    n_layers = cfg.n_layers if n_steps_cut is None else 0
    with smoke.StepRecorder(n_layers) as rec:
        assert attention.attention_decode_paged is not orig
        engine.serve(ps, forced_gen_lens=[6, 9, 4, 12, 3], max_gen=16)
    assert attention.attention_decode_paged is orig
    assert rec.calls == cfg.n_layers * engine.n_decode_steps > 0
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
    dense engine (the first layer's scan): rows, chunk-padded tokens and
    each row's valid tokens, the prompt's own length on the first slice
    and prompt + generated on the re-prefill, batch-bucket pad rows the
    one pad token the engine gives them; the
    ops' scan restored on exit.  ``timed_stages`` picks the upper median by
    rows x tokens and the largest."""
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
    orig = ops.ssd_chunked_scan
    engine.n_prefill_stages = 0
    with smoke.StageRecorder(model.cfg.n_layers) as rec:
        assert ops.ssd_chunked_scan is not orig
        first = engine.serve_batch(ps, 4, forced_gen_lens=[6, 6, 6])
        gen = [r["tokens"] for r in first.results]
        engine.serve_batch(ps[:2], 4, forced_gen_lens=[2, 2],
                           already_generated=gen[:2])
    assert ops.ssd_chunked_scan is orig
    assert rec.calls == model.cfg.n_layers * engine.n_prefill_stages
    assert len(rec.stages) == engine.n_prefill_stages == 2
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
