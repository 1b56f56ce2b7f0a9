"""The fixtures here are lint corpus, not tests: ``cuda_*/tests/
test_torch_cuda.py`` are the card tests of two small trees laid out as
the repository (``python -m repro_torch.analysis --repo <tree>``), and
pytest must not collect them."""
collect_ignore_glob = ["*"]
