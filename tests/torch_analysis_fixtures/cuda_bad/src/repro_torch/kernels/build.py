"""Build list of the bad fixture (never imported): one kernel a check."""
KERNELS = (
    "nosource",       # 1: no csrc/nosource.cu (and csrc/orphan.cu unlisted)
    "nomodule",       # 2: no kernels/nomodule.py
    "undispatched",   # 3: ops.py never imports it
    "noref",          # 4: ref.py has no noref_ref
    "ungated",        # 5: launched before _on_cpu, no _refuse_grad
    "rescued",        # 6: an except handler takes the plain version
    "switched",       # 7: torch.cuda.is_available() picks the plain version
    "untested",       # 8: no cuda-marked test calls it and untested_ref
)
