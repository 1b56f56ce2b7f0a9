"""Hand-written CUDA kernels for Hopper, their plain versions and their
dispatch (``ops``).  Nothing here builds or loads a kernel at import."""
