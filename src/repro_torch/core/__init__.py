"""Scheduler core: the paper's Eq. 1-12 and Algorithms 1-2, pure Python."""
