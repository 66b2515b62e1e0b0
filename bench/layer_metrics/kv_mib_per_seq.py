"""Cache: physical cache bytes per slot, in MiB (dense: the resident
slots-wide store; paged: the pool's peak allocated blocks plus the
metadata), the largest over the window's batches."""


def read(rec):
    slots = rec.cell["slots"]
    return max(b.result.cache_physical_bytes
               for b in rec.batches) / slots / 2 ** 20
