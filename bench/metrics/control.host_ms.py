"""Mean milliseconds an event epoch spends outside its solves: the
`control.epoch` span less the `control.solve` spans inside it (chaos, the
hop-bound cache, repair and the controller's own bookkeeping)."""


def read(reading):
    spans = reading["spans"]
    solve = {}
    for s in spans:
        if s.name == "control.solve":
            solve[s.parent] = solve.get(s.parent, 0.0) + s.dur
    host = [s.dur - solve.get(s.id, 0.0) for s in spans
            if s.name == "control.epoch" and s.attrs.get("events", 0) > 0]
    return 1e3 * sum(host) / len(host) if host else None
