"""Traffic mixes: one JSON file of parameters each, read by the one
generator in `road`."""
