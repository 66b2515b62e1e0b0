"""Scheduler: the 90th percentile, over the unprofiled batches' requests,
of each request's queue wait (the scheduler's ``queue_s``: submit to its
first admission; a failed request counts as +inf, as the tails do). None
for a program that does not report it."""
import math

from bench.harness import work


def read(rec):
    waits = []
    for r in rec.results:
        q = getattr(r, "queue_s", None)
        if q is None:
            return None
        waits.append(math.inf if r.finish_reason == "failed" else q)
    return work.percentile(waits, 0.90) if waits else None
