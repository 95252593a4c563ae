"""Config dataclasses of the ported models."""
