from repro_torch.data.synthetic import (  # noqa: F401
    lm_batches, needle_prompt, synthetic_tokens,
)
