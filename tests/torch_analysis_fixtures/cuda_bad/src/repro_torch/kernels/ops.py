"""The bad fixture's wrappers (never imported)."""
import torch

from repro_torch.kernels import nomodule as _nomodule
from repro_torch.kernels import nosource as _nosource
from repro_torch.kernels import noref as _noref
from repro_torch.kernels import ref
from repro_torch.kernels import rescued as _rescued
from repro_torch.kernels import switched as _switched
from repro_torch.kernels import ungated as _ungated
from repro_torch.kernels import untested as _untested


def _on_cpu(t, name):
    return not t.is_cuda


def _refuse_grad(name, *tensors):
    pass


def nosource(x):
    if _on_cpu(x, "nosource"):
        return ref.nosource_ref(x)
    _refuse_grad("nosource", x)
    return _nosource.nosource(x)


def nomodule(x):
    if _on_cpu(x, "nomodule"):
        return ref.nomodule_ref(x)
    _refuse_grad("nomodule", x)
    return _nomodule.nomodule(x)


def noref(x):
    if _on_cpu(x, "noref"):
        return x
    _refuse_grad("noref", x)
    return _noref.noref(x)


def ungated(x):
    y = _ungated.ungated(x)
    if _on_cpu(x, "ungated"):
        return ref.ungated_ref(x)
    return y


def rescued(x):
    if _on_cpu(x, "rescued"):
        return ref.rescued_ref(x)
    _refuse_grad("rescued", x)
    try:
        return _rescued.rescued(x)
    except RuntimeError:
        return ref.rescued_ref(x.cpu())


def switched(x):
    if not torch.cuda.is_available():
        return ref.switched_ref(x)
    if _on_cpu(x, "switched"):
        return ref.switched_ref(x)
    _refuse_grad("switched", x)
    return _switched.switched(x)


def untested(x):
    if _on_cpu(x, "untested"):
        return ref.untested_ref(x)
    _refuse_grad("untested", x)
    return _untested.untested(x)
