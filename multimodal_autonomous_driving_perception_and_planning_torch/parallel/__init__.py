"""Multi-camera scale-out."""
