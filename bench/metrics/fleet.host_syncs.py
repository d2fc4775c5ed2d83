"""Host syncs a re-plan: the `host_syncs` attribute of the
`solve_fleet.call` spans (every host wait on the device inside the call),
over the re-plans run."""


def read(reading):
    n = len(reading["record"].get("replans", []))
    syncs = [s.attrs["host_syncs"] for s in reading["spans"]
             if s.name == "solve_fleet.call" and "host_syncs" in s.attrs]
    return sum(syncs) / n if syncs and n else None
