"""Share of the profiled search's wall time in which no operation ran on
the device: 1 - (union of the device operations' intervals / wall)."""
UNIT = "%"
LAYER = "device"
MOVES = "trials_per_s"


def read(view):
    prof = view.profile
    if prof is None or prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
