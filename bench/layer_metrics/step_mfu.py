"""Model step: the model FLOPs of every request the traced window served
(prefill and decode, attention over what each row sees; worked out from the
configuration and the requests' lengths) over the window's wall time and
the card's bf16 peak."""

from bench.harness import work


def read(rec):
    flops = sum(rec.shape.request_flops(r.prompt_len, r.n_tokens)
                for r in rec.results)
    return 100.0 * flops / (rec.window_s * work.PEAK_BF16_FLOPS)
