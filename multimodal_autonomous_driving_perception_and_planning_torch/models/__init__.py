"""Learned models of the port: the YOLOv8 detector."""
