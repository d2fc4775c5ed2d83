"""Mean milliseconds of the `solve_fleet.stack` span a re-plan: padding
and stacking the fleet into one batch."""


def read(reading):
    n = len(reading["record"].get("replans", []))
    stack = [s.dur for s in reading["spans"] if s.name == "solve_fleet.stack"]
    return 1e3 * sum(stack) / n if stack and n else None
