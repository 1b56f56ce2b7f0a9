"""Model code: the dense transformer, its attention and registry."""
