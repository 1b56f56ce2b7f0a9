"""Bad fixture launcher module (never imported)."""


def ungated(x):
    return x
