"""Perception frontends of the port: YOLO detection over camera frames."""
