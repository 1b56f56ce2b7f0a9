"""The bad fixture's card tests (never collected): ``untested`` is only
called by a test without the cuda mark, and never beside untested_ref."""
import pytest

from repro_torch.kernels import nomodule, nosource, noref, ops, ref
from repro_torch.kernels import rescued, switched, undispatched, ungated

pytestmark = pytest.mark.cuda


def test_each_matches_plain(cuda_device):
    x = cuda_device
    assert nosource.nosource(x) == ref.nosource_ref(x)
    assert nomodule.nomodule(x) == ref.nomodule_ref(x)
    assert undispatched.undispatched(x) == ref.undispatched_ref(x)
    assert noref.noref(x) == x
    assert ungated.ungated(x) == ref.ungated_ref(x)
    assert ops.rescued(x) == ref.rescued_ref(x)
    assert switched.switched(x) == ref.switched_ref(x)
    assert ops.untested(x) == x
