"""Ego state estimation."""

from .ego import estimator_step, extract_state, set_initial_state

__all__ = ["estimator_step", "extract_state", "set_initial_state"]
