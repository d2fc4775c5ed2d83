"""Milliseconds a round of the `solve_fleet.round.placement` spans, over
the rounds run: the placement sweep on the host's clock, including the
waits of its APSP's min-plus closure on its own sweeps (`device.sync`
spans inside)."""


def read(reading):
    rounds = sum(r["rounds"] for r in reading["record"].get("replans", []))
    spans = [s.dur for s in reading["spans"] if s.name == "solve_fleet.round.placement"]
    return 1e3 * sum(spans) / rounds if spans and rounds else None
