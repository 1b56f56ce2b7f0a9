"""Model code: the dense transformer and its attention, the Mamba-2 SSM,
and the registry."""
