"""Mean milliseconds of the `solve_fleet.pad` span a re-plan: padding each
lane to the fleet envelope and building its masks, inside the stack."""


def read(reading):
    n = len(reading["record"].get("replans", []))
    pad = [s.dur for s in reading["spans"] if s.name == "solve_fleet.pad"]
    return 1e3 * sum(pad) / n if pad and n else None
