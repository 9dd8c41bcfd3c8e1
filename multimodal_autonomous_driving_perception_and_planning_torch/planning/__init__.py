"""Motion planning."""
