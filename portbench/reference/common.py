"""Plain float32 building blocks of the references.  Nothing here
imports the port; matrix products run with TF32 off.

`control=True` computes every matrix product on TF32 inputs (both
operands rounded to 10 mantissa bits, to nearest, then an f32 product),
the precision below the configurations' float32: the benchmark's
control, which its comparison has to refuse."""
from __future__ import annotations

import math

import torch


def exact_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), kept in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, control: bool) -> torch.Tensor:
    if control:
        a, b = tf32(a), tf32(b)
    return torch.matmul(a, b)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
           control: bool) -> torch.Tensor:
    if control:
        a, b = tf32(a), tf32(b)
    return torch.einsum(eq, a, b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric INT8 over the last dim with an f16 scale, as a
    paged K/V pool stores a (token, kv head) row, read back to f32."""
    scale = (x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
             ).to(torch.float16).to(torch.float32)
    return torch.clamp(torch.round(x / scale), -127.0, 127.0) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split halves, at positions 0..s-1: x (n, s, h,
    hd)."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)
