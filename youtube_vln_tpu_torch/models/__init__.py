"""The Lily model in PyTorch."""
from .vilbert import Lily

__all__ = ["Lily"]
