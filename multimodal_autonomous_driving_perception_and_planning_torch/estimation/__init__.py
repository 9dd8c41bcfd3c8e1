"""Ego state estimation."""
