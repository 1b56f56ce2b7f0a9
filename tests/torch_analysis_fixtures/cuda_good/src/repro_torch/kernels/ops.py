"""The good fixture's wrappers (never imported): a DTensor branch first,
then the device gate, the plain version on the CPU, the grad refusal and
the launch."""
import torch

from repro_torch.kernels import goodkernel as _good
from repro_torch.kernels import ref


def _on_cpu(t, name):
    return not t.is_cuda


def _refuse_grad(name, *tensors):
    pass


def goodkernel(x):
    if x.ndim == 0:
        return goodkernel(x[None])[0]
    if _on_cpu(x, "goodkernel"):
        return ref.goodkernel_ref(x)
    _refuse_grad("goodkernel", x)
    try:
        return _good.goodkernel(x)
    except RuntimeError as e:  # a handler that re-raises is fine
        raise RuntimeError(f"goodkernel failed: {e}") from e


def available():
    # an availability test that selects no plain version is fine
    return torch.cuda.is_available()
