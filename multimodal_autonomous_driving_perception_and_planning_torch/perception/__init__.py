"""Perception frontends of the port: the lane step over camera frames, and
YOLO detection (`perception.detector`)."""

from .lanes import fit_lane_polynomial, make_lane_step

__all__ = ["make_lane_step", "fit_lane_polynomial"]
