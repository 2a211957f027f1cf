"""VDI artifacts and wire compression."""
