"""Synthetic shared corpora."""
