"""Distribution substrate of the port: so far the inter-pod gradient
compression (`compress`); the mesh rules and sharding helpers come with
tensor parallelism."""
from .compress import (compress_decompress_roundtrip, compress_with_feedback,
                       init_error_state)

__all__ = ["compress_decompress_roundtrip", "compress_with_feedback",
           "init_error_state"]
