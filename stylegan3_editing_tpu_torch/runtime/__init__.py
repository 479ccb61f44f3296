"""Checkpoint I/O of the port (numpy format, no orbax)."""

from .checkpoint import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
