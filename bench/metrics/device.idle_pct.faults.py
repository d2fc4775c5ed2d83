"""Share of the traced control epochs in which no operation ran on the
device, from the torch.profiler timeline."""


def read(reading):
    prof = reading["profile"]
    if not prof or not reading["record"].get("epochs") or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
