"""Serve-path kernels: CUDA C++ sources in `repro_torch/csrc/`, each with
a plain PyTorch version beside its wrapper.  Importing this package
builds nothing; see `_build`."""
from .ops import (decode_attention, launch_counts, paged_decode_attention,
                  paged_verify_attention, qmatmul, reset_launch_counts,
                  swiglu)

__all__ = ["decode_attention", "launch_counts", "paged_decode_attention",
           "paged_verify_attention", "qmatmul", "reset_launch_counts",
           "swiglu"]
