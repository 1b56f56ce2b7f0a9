"""Bad fixture launcher module (never imported)."""


def nosource(x):
    return x
