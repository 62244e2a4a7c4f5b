"""PyTorch/CUDA port of the EdgeCIM serving stack (`repro`).

The JAX package `repro` stays the reference; this package mirrors its
module names (`repro_torch.quant.qarray` is the counterpart of
`repro.quant.qarray`, and so on) and imports neither `jax` nor `repro`.

First slice: INT4/INT8 packed weights and INT8 paged KV served by
`serve.engine.PagedServeEngine` for dense GQA + SwiGLU decoders, with the
three hot-path TPU kernels (`cim_gemv`, `swiglu_qgemv`,
`paged_flash_decode`) rewritten in CUDA C++ for Hopper (`csrc/`).
Importing the package compiles nothing: kernels build on first launch.
"""

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller asks
    for something else.  With no card and no explicit request this
    raises instead of silently serving on the CPU."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
