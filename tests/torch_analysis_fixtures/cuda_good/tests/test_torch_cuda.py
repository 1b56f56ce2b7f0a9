"""The good fixture's card test (never collected)."""
import pytest

from repro_torch.kernels import goodkernel as good
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


def test_goodkernel_matches_plain(cuda_device):
    x = cuda_device
    assert good.goodkernel(x) == ref.goodkernel_ref(x)
