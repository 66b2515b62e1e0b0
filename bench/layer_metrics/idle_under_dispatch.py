"""Device: share of the profiled slice's device idle time (its wall time
less the union of device operations) that falls inside the engine's
``decode`` spans, the model's dispatch. None where the slice holds no
``decode`` span or no idle time."""


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(rec):
    sl = rec.slice
    if sl is None:
        return None
    t0, t1 = sl.t0, sl.t0 + sl.wall_s
    spans = _merged((max(a, t0), min(b, t1)) for n, a, b, _ in sl.spans
                    if n == "decode" and b > t0 and a < t1)
    if not spans:
        return None
    idle, end = [], t0
    for a, b in _merged((a, b) for _, a, b in sl.ops):
        if a > end:
            idle.append((end, a))
        end = max(end, b)
    if end < t1:
        idle.append((end, t1))
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    inside, j = 0.0, 0
    for a, b in idle:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            inside += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return 100.0 * inside / total
