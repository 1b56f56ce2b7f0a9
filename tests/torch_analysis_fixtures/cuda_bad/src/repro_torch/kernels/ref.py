"""The bad fixture's plain versions (never imported); noref_ref is
missing."""


def nosource_ref(x):
    return x


def nomodule_ref(x):
    return x


def undispatched_ref(x):
    return x


def ungated_ref(x):
    return x


def rescued_ref(x):
    return x


def switched_ref(x):
    return x


def untested_ref(x):
    return x
