"""Bad fixture launcher module (never imported)."""


def untested(x):
    return x
