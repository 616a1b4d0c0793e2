"""Synthetic shared corpora and training batches."""
