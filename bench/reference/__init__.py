"""The plain reference the benchmark's check holds the port to. It imports
torch and numpy only: nothing of the port, nothing of JAX."""
