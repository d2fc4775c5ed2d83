"""Mean round-loop trips a re-plan (`FleetResult.rounds`)."""


def read(reading):
    reps = reading["record"].get("replans", [])
    return sum(r["rounds"] for r in reps) / len(reps) if reps else None
