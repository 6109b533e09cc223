"""Losses (the eval slice needs only pad_packed)."""
