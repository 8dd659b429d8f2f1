"""Reading reference snapshots and fixtures."""
