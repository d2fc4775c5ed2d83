"""Share of phi's envelope that is padding, in percent: 100 (1 - real /
envelope) over the window's `solve_fleet.stack` spans, whose `real_cells`
count the real lanes' (app, stage, node, node) entries, A (P + 1) V^2
each, and `envelope_cells` what the stacked envelope holds for those
lanes."""


def read(reading):
    stacks = [s.attrs for s in reading["spans"]
              if s.name == "solve_fleet.stack" and "envelope_cells" in s.attrs]
    envelope = sum(a["envelope_cells"] for a in stacks)
    if not envelope:
        return None
    return 100.0 * (1.0 - sum(a["real_cells"] for a in stacks) / envelope)
