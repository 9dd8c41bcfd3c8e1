"""Applications over the pipeline: the inference server."""
