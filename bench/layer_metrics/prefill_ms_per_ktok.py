"""Admission: host milliseconds of monolithic prefill per thousand prompt
tokens over the window (each admission's prefill span includes the read of
its first token, so it ends with the device's work)."""


def read(rec):
    if rec.cell["engine"].get("chunked_prefill"):
        return None
    ktok = sum(r.prompt_len for r in rec.results) / 1e3
    if not ktok:
        return None
    return 1e3 * sum(b.result.prefill_seconds for b in rec.batches) / ktok
