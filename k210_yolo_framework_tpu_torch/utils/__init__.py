"""Numpy-only helpers."""
