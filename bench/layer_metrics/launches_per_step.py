"""Model step: device operations (kernels, copies, fills) per decode step
in the profiled slice, admissions' included."""


def read(rec):
    sl = rec.slice
    if sl is None or not sl.decode_steps:
        return None
    return len(sl.ops) / sl.decode_steps
