"""Motion planning."""

from .planner import make_reference_path, plan

__all__ = ["plan", "make_reference_path"]
