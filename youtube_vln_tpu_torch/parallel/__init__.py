"""Batch transports of the scoring step."""
