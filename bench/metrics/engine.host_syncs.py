"""Host syncs a round: the `host_syncs` attribute of the
`solve_fleet.round` spans (the exit-flag read and the min-plus closure's
tests), over the rounds run."""


def read(reading):
    rounds = sum(r["rounds"] for r in reading["record"].get("replans", []))
    syncs = [s.attrs["host_syncs"] for s in reading["spans"]
             if s.name == "solve_fleet.round" and "host_syncs" in s.attrs]
    return sum(syncs) / rounds if syncs and rounds else None
