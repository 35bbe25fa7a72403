"""Checkpoint reading (training itself comes with a later part of the port)."""
