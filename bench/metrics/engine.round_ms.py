"""Milliseconds a round: the `solve_fleet.execute` spans (which end after
the device has finished while tracing is on) over the rounds they ran."""


def read(reading):
    reps = reading["record"].get("replans", [])
    execute = [s.dur for s in reading["spans"] if s.name == "solve_fleet.execute"]
    rounds = sum(r["rounds"] for r in reps)
    return 1e3 * sum(execute) / rounds if execute and rounds else None
