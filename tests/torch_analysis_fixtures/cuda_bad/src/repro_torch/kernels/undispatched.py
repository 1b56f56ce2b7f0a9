"""Bad fixture launcher module (never imported)."""


def undispatched(x):
    return x
