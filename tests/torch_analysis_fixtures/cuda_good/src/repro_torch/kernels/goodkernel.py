"""The good fixture's launcher module (never imported)."""
launches = 0


def reset_launches():
    global launches
    launches = 0


def goodkernel(x):
    global launches
    launches += 1
    return x
