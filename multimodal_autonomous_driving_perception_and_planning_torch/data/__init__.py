"""Synthetic parity fixtures (numpy only)."""
