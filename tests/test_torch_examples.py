"""The port's examples (``examples/torch_*.py``), each run through its
``main`` on the CPU at its smallest arguments: the quickstart's token
parity with one-shot generation (8/8) through the plain versions of B5
and B6, the serving cluster's three sections (every strategy completes,
the asyncio clients' admission and cancel, and zero re-prefill with
retained pages), the slice-length sweep's trend (a longer slice, fewer
slices a request), and the trainer's improved loss and bit-equal
checkpoint.  Without a card and without ``--device cpu`` each refuses to
run."""
import importlib.util
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_one_shot_generation():
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert out["parity"] == out["checked"] == 8
    assert out["n_completed"] == out["n_requests"] > 8
    assert out["plain_calls"]["flash_prefill"] > 0
    assert out["plain_calls"]["decode_attention"] > 0
    assert not any(out["launches"].values())  # no kernel on the CPU


def test_serving_cluster_runs_its_three_sections():
    from repro_torch.core.schedulers import ALL_STRATEGIES
    out = _example("torch_serving_cluster").main(
        ["--device", "cpu", "--duration", "20", "--rate", "10"])
    assert set(out["sim"]) == set(ALL_STRATEGIES)
    assert all(v["n_completed"] > 0 for v in out["sim"].values())
    assert out["aio"] is True
    real = out["real"]
    assert real["reprefill_tokens"] == 0 and real["n_completed"] == 3
    assert max(real["slices"]) >= 3
    assert real["plain_calls"]["paged_prefill_write"] > 0
    assert real["plain_calls"]["paged_decode_attention"] > 0


def test_slice_length_sweep_trades_slices_for_length():
    out = _example("torch_slice_length_sweep").main(
        ["--duration", "20", "--slice-lens", "16,128"])
    for strat in ("scls", "scls-pred"):
        short, long_ = out[(strat, 16)], out[(strat, 128)]
        assert short["n_completed"] > 0 and long_["n_completed"] > 0
        assert short["slices"] > long_["slices"]


def test_train_lm_improves_and_checkpoints(tmp_path):
    out = _example("torch_train_lm").main(
        ["--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
         "--ckpt", str(tmp_path / "ckpt")])
    assert out["improved"] and out["checkpoint_equal"]
    assert out["steps"] == 12


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []),
    ("torch_serving_cluster", ["--section", "real"]),
    ("torch_train_lm", ["--steps", "1"]),
])
def test_examples_need_a_card_unless_told_the_cpu(name, argv, monkeypatch,
                                                  tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv + ["--ckpt", str(tmp_path)]
                            if name == "torch_train_lm" else argv)
