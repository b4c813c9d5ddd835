"""Host-side utilities of the port (standard library only)."""
