"""The good fixture's plain versions (never imported)."""


def goodkernel_ref(x):
    return x
