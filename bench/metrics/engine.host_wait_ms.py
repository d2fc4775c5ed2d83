"""Milliseconds a round the host waits on the device inside a round: the
`device.sync` spans (the exit-flag read, the min-plus closure's tests)
that descend from a `solve_fleet.round` span, over the rounds run."""


def read(reading):
    rounds = sum(r["rounds"] for r in reading["record"].get("replans", []))
    by_id = {s.id: s for s in reading["spans"]}

    def in_round(s):
        p = by_id.get(s.parent)
        while p is not None and p.name != "solve_fleet.round":
            p = by_id.get(p.parent)
        return p is not None

    waits = [s.dur for s in by_id.values() if s.name == "device.sync" and in_round(s)]
    return 1e3 * sum(waits) / rounds if waits and rounds else None
