"""Input transforms of the serving path."""

from .transforms import to_tensor

__all__ = ["to_tensor"]
