from repro_torch.checkpoint.io import load_pytree, save_pytree  # noqa: F401
