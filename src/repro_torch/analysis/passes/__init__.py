"""Pass registry — importing this package registers every rule.

Adding a pass: create a module here, subclass
:class:`repro_torch.analysis.framework.AnalysisPass`, decorate it with
``@register``, and import the module below.
"""
from repro_torch.analysis.passes import (allocator_pairing,  # noqa: F401
                                         api_typing, cuda_conventions,
                                         determinism, docs_refs, obs_guard)

from repro_torch.analysis.passes.allocator_pairing import AllocatorPairingPass
from repro_torch.analysis.passes.api_typing import ApiTypingPass
from repro_torch.analysis.passes.cuda_conventions import CudaConventionsPass
from repro_torch.analysis.passes.determinism import DeterminismPass
from repro_torch.analysis.passes.docs_refs import DocsRefsPass
from repro_torch.analysis.passes.obs_guard import ObsGuardPass

__all__ = [
    "AllocatorPairingPass",
    "ApiTypingPass",
    "CudaConventionsPass",
    "DeterminismPass",
    "DocsRefsPass",
    "ObsGuardPass",
]
