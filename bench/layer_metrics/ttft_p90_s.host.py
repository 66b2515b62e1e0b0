"""Scheduler and admission, where the host sets the pace: the 90th
percentile, over all requests of the traced window, of the time from their
batch's submit to their first token."""


def read(rec):
    return rec.window["ttft_p90_s"]
