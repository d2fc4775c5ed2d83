"""Milliseconds a round of the `solve_fleet.round.eval` spans, over the
rounds run: `round_eval` on the host's clock, which launches work the
round's exit-flag read later waits for."""


def read(reading):
    rounds = sum(r["rounds"] for r in reading["record"].get("replans", []))
    spans = [s.dur for s in reading["spans"] if s.name == "solve_fleet.round.eval"]
    return 1e3 * sum(spans) / rounds if spans and rounds else None
