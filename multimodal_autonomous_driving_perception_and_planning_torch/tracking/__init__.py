"""Multi-object tracking."""
