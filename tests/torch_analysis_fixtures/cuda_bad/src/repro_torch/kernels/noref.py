"""Bad fixture launcher module (never imported)."""


def noref(x):
    return x
