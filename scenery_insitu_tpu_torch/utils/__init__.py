"""Host-boundary utilities."""
