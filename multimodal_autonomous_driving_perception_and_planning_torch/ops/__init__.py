"""Tensor ops and the wrappers of the hand-written kernels: the JAX
package's public ops, in its order."""

from .geometry import pairwise_iou
from .association import greedy_associate
from .kalman import kalman_predict, kalman_update, make_constant_accel_model
from .quintic import generate_candidates, evaluate_costs

__all__ = [
    "pairwise_iou",
    "greedy_associate",
    "kalman_predict",
    "kalman_update",
    "make_constant_accel_model",
    "generate_candidates",
    "evaluate_costs",
]
