"""Bad fixture launcher module (never imported)."""


def rescued(x):
    return x
