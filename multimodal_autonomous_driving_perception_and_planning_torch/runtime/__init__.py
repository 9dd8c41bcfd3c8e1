"""The native frame ring (C++ producer threads, built at first use) and the
chunked stream driver over it (`runtime.stream.run_stream`)."""

from .loader import NativeFrameSource, build_runtime

__all__ = ["NativeFrameSource", "build_runtime"]
