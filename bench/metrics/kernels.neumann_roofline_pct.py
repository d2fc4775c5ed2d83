"""The profiled re-plan's Neumann launches: their least time over their
device time, in percent.

Least time: every `kernels.neumann` span under the window's first
`solve_fleet.call` (the re-plan the profiler captured) that launched a
kernel reads its N operators and right-hand sides and writes its results
once, N (V^2 + 2 V) esize bytes (`roofline.py`'s per-solve convention),
over the H100's memory bandwidth. Device time: the profile's kernels whose
names hold `neumann_rows` or `neumann_cols`. None unless every kind the
spans launched shows among them."""
import roofline

KINDS = {False: "neumann_rows", True: "neumann_cols"}


def _under(span, root_id, parent_of) -> bool:
    sid = span.parent
    while sid != -1:
        if sid == root_id:
            return True
        sid = parent_of.get(sid, -1)
    return False


def read(reading):
    spans, prof = reading["spans"], reading["profile"]
    calls = [s.id for s in spans if s.name == "solve_fleet.call"]
    if not calls or not prof:
        return None
    parent_of = {s.id: s.parent for s in spans}
    launched = [s for s in spans if s.name == "kernels.neumann"
                and s.attrs.get("variant") not in (None, "plain") and _under(s, min(calls), parent_of)]
    if not launched:
        return None
    nbytes = sum(a["systems"] * (a["v"] ** 2 + 2 * a["v"]) * a["esize"]
                 for a in (s.attrs for s in launched))
    device_s = 0.0
    for kind in {KINDS[bool(s.attrs["transpose"])] for s in launched}:
        kind_s = sum(sec for name, sec in prof["device_ops"] if kind in name)
        if kind_s <= 0:
            return None
        device_s += kind_s
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / device_s
