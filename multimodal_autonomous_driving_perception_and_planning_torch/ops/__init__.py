"""Tensor ops and the wrappers of the hand-written kernels."""

from .association import greedy_associate

__all__ = ["greedy_associate"]
