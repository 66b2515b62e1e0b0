"""Device: share of the profiled slice's wall time in which no operation
ran on the device."""


def read(rec):
    sl = rec.slice
    if sl is None or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)
