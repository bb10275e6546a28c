"""Checkpoint bridge (training itself is not ported yet)."""
