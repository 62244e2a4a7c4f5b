"""Public entry points of the serve-path kernels.

Counterpart of `repro.kernels.ops`.  Every packed weight goes through a
kernel wrapper, which runs the CUDA kernel for CUDA tensors and the
plain PyTorch version for CPU tensors.  There is no "aligned, else the
reference" dispatch: on the card every shape the model hands over goes
to the kernel, and a shape the kernel cannot take raises.  Float
(unquantized) weights are plain matrix products, as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch

from repro_torch.dist.shard import tp_all_gather, tp_all_reduce
from repro_torch.quant.qarray import QTensor

from . import launches
from .cim_gemv import cim_gemv
from .flash_decode import flash_decode
from .paged_flash_decode import paged_flash_decode, paged_flash_verify
from .ref import ref_flash_decode
from .swiglu_gemv import swiglu_qgemv

KERNELS = {"cim_gemv": cim_gemv, "swiglu_qgemv": swiglu_qgemv,
           "paged_flash_decode": paged_flash_decode,
           "paged_flash_verify": paged_flash_verify,
           "flash_decode": flash_decode}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, in the whole process (CPU
    calls never count; a CUDA graph's kernels count once per replay)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def thread_launch_counts(thread: Optional[threading.Thread] = None
                         ) -> Dict[str, int]:
    """Kernel launches since the last reset on one thread (the calling
    one by default): an engine replica's are its driver thread's."""
    tally = launches.thread_counts(thread)
    return {name: tally.get(name, 0) for name in KERNELS}


def reset_launch_counts() -> None:
    launches.reset(KERNELS.values())


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches no wrapper call made, on the calling thread: a
    CUDA graph replay runs the kernels its capture recorded, and a
    capture runs none of the launches its wrapper calls counted
    (`serve.graphs.StepRunner`)."""
    for name, n in counts.items():
        if n:
            launches.launched(KERNELS[name], n)


def qmatmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ W for a float weight, a packed `(K/2, N)` projection, or the
    packed `(V, K/2)` tied table (then x @ table.T, the logits head).
    x: (..., K) -> (..., N)."""
    if not isinstance(w, QTensor):
        return torch.matmul(x, w.to(x.dtype))
    lead = x.shape[:-1]
    out = cim_gemv(x.reshape(-1, x.shape[-1]).contiguous(), w)
    n = w.data.shape[0] if w.axis == -1 else w.data.shape[-1]
    return out.reshape(*lead, n).to(x.dtype)


def rank_rows(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ W over this rank's rows of a row-parallel W, before the sum
    over the ranks: `cim_gemv`'s f32 output for a packed W, x's dtype for
    a float one.  x: (..., K_rank) -> (..., N)."""
    if not isinstance(w, QTensor):
        return torch.matmul(x, w.to(x.dtype))
    lead = x.shape[:-1]
    out = cim_gemv(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return out.reshape(*lead, w.data.shape[-1])


def row_parallel(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ W for a row-parallel weight (attention's `wo`, the FFN's
    `w_down`) under tensor parallelism (`dist.shard.use_tp`): the rank's
    rows of W times its columns of x (`rank_rows`), summed over the ranks
    in f32 (the packed route's `cim_gemv` output) before the cast to x's
    dtype.  A W the sharding rule left whole (its group count does not
    divide by the ranks) takes the ranks' x gathered and sums nothing.
    Outside `use_tp` this is `qmatmul`."""
    if w.shape[-2] != x.shape[-1]:
        return qmatmul(tp_all_gather(x, -1), w)
    return tp_all_reduce(rank_rows(x, w)).to(x.dtype)


def expert_qmatmul(x: torch.Tensor, w: Any, counts: torch.Tensor
                   ) -> torch.Tensor:
    """x (E, C, K) against an expert stack (E, K, N) -> (E, C, N): a
    packed stack goes to `cim_gemv`'s stack layout, which computes only
    the first counts[e] rows of expert e on the card (the rest are
    unspecified there); a float stack is one batched product, as the
    JAX package's einsum."""
    if not isinstance(w, QTensor):
        return torch.einsum("ecd,edf->ecf", x, w.to(x.dtype))
    return cim_gemv(x.contiguous(), w, counts).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: Any, w_up: Any) -> torch.Tensor:
    """silu(x @ Wg) * (x @ Wu): the fused kernel for packed weights, two
    matrix products for float ones."""
    if isinstance(w_gate, QTensor) and isinstance(w_up, QTensor):
        lead = x.shape[:-1]
        out = swiglu_qgemv(x.reshape(-1, x.shape[-1]).contiguous(),
                           w_gate, w_up)
        return out.reshape(*lead, w_gate.data.shape[-1]).to(x.dtype)
    g = qmatmul(x, w_gate).to(torch.float32)
    u = qmatmul(x, w_up).to(torch.float32)
    return (g * torch.sigmoid(g) * u).to(x.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, window: int = 0,
                           attn_cap: float = 0.0,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Paged decode attention: q (b, g, qpk, hd), pools (n_pages, ps, g,
    hd), tables (b, max_pages), lengths (b,) -> (b, g, qpk, hd)."""
    return paged_flash_decode(q, k_pages, v_pages, tables, lengths,
                              window=window, attn_cap=attn_cap,
                              k_scales=k_scales, v_scales=v_scales)


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, window: int = 0,
                           attn_cap: float = 0.0,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Multi-query paged attention for speculative verify windows: q (b,
    s, g, qpk, hd), query j of lane i at position lengths[i] + j;
    lengths EXCLUDE the window.  Returns (b, s, g, qpk, hd)."""
    return paged_flash_verify(q, k_pages, v_pages, tables, lengths,
                              window=window, attn_cap=attn_cap,
                              k_scales=k_scales, v_scales=v_scales)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, window: int = 0, attn_cap: float = 0.0,
                     use_kernel: bool = True) -> torch.Tensor:
    """q (b, g, qpk, hd); k/v (b, S, g, hd) -> (b, g, qpk, hd).  Any S
    goes to the kernel (it masks its own ragged edge); `use_kernel=False`
    asks for the plain version."""
    if not use_kernel:
        return ref_flash_decode(q, k, v, pos, window, attn_cap)
    b, g, qpk, hd = q.shape
    S = k.shape[1]
    kf = k.transpose(1, 2).reshape(b * g, S, hd)
    vf = v.transpose(1, 2).reshape(b * g, S, hd)
    out = flash_decode(q.reshape(b * g, qpk, hd), kf, vf, pos,
                       window=window, attn_cap=attn_cap)
    return out.reshape(b, g, qpk, hd)
