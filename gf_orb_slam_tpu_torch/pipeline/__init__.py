"""Per-frame tracking and the local-map track view."""
