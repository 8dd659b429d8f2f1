"""Map state (read side) and per-frame containers."""
