"""Engine loop, where the host sets the pace: the 95th percentile of every
gap between consecutive tokens of every request of the traced window."""


def read(rec):
    return rec.window["itl_p95_ms"]
