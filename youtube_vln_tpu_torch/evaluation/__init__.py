"""Beam re-ranking inference."""
