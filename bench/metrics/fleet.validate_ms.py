"""Mean milliseconds of the `solve_fleet.validate` span a re-plan: the
input checks, which read every instance to the host."""


def read(reading):
    n = len(reading["record"].get("replans", []))
    validate = [s.dur for s in reading["spans"] if s.name == "solve_fleet.validate"]
    return 1e3 * sum(validate) / n if validate and n else None
