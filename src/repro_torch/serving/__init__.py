"""Slotted serving engine."""
