"""Host-side helpers (direction parsing)."""
