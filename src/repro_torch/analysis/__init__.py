"""repro_torch.analysis — the port's static-analysis suite (the
counterpart of ``repro.analysis``; standard library only).

  ============================  ===========================================
  rule                          invariant
  ============================  ===========================================
  ``allocator-pairing``         every ``PageAllocator`` acquisition reaches
                                a release on all exit paths (CFG dataflow)
  ``obs-guard``                 every ``*.obs.on_*`` hook call is behind
                                ``if *.obs.enabled:``
  ``determinism``               golden-pinned modules: no wall clocks,
                                unseeded RNGs, id()/hash() ordering, or
                                unordered-set iteration
  ``cuda-conventions``          each kernel of ``kernels/build.py``'s
                                ``KERNELS`` has its source, module, gated
                                ``ops`` wrapper, plain version and card
                                test; nothing falls back to the plain
                                version on the card
  ``api-typing``                repro_torch.kvcache / serving / fleet
                                signatures fully annotated
  ``docs-refs``                 README.md and PERF.md ``path.py:Symbol``
                                refs + local links resolve
  ============================  ===========================================

Run it::

    PYTHONPATH=src python -m repro_torch.analysis --all
    PYTHONPATH=src python -m repro_torch.analysis --rule obs-guard \\
        src/repro_torch/serving

Suppress a single accepted exception (with a justification), in the JAX
package's syntax::

    pages = alloc.reserve(rid, n)  # repro: transfer(allocator-pairing) — why
"""
from repro_torch.analysis.framework import (AnalysisPass, AnalysisReport,
                                            Finding, PASSES, SourceFile,
                                            all_rules, find_repo_root,
                                            load_baseline, register,
                                            run_analysis, write_baseline)

__all__ = [
    "AnalysisPass",
    "AnalysisReport",
    "Finding",
    "PASSES",
    "SourceFile",
    "all_rules",
    "find_repo_root",
    "load_baseline",
    "register",
    "run_analysis",
    "write_baseline",
]
