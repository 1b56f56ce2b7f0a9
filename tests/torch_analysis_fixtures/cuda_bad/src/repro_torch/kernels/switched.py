"""Bad fixture launcher module (never imported)."""


def switched(x):
    return x
