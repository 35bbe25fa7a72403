"""The cells' drivers, one per kind of window (loaded by file name)."""
