"""Launches of the program's hand-written kernels (all of
`kernels._build.LAUNCHES`) a round, over the window's re-plans."""


def read(reading):
    reps = reading["record"].get("replans", [])
    rounds = sum(r["rounds"] for r in reps)
    return sum(r["launches"] for r in reps) / rounds if rounds else None
