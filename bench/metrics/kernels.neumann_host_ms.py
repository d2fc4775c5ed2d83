"""Milliseconds a round of the program's `kernels.neumann` spans, over the
rounds run: one span a `neumann_propagate` call, the wrapper's checks,
its layout choice and the launch on the host's clock."""


def read(reading):
    rounds = sum(r["rounds"] for r in reading["record"].get("replans", []))
    spans = [s.dur for s in reading["spans"] if s.name == "kernels.neumann"]
    return 1e3 * sum(spans) / rounds if spans and rounds else None
