"""State conversion utilities."""
