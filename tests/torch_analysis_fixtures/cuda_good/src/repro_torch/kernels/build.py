"""Build list of the good fixture (never imported)."""
KERNELS = ("goodkernel",)
