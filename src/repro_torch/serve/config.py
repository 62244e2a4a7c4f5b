"""ServeConfig — the typed configuration of the serving stack (PyTorch
port of `repro.serve.config`).

`precision` is the serving precision of the hot path:

  "fp"    float weights, float KV
  "int8"  packed INT8 weights (QTensor, per-group scales)
  "int4"  packed INT4 weights — the paper's headline operating point

`kv_dtype` picks the paged-KV pool storage independently:

  "auto"  int8 pools when precision is quantized, bf16 otherwise
  "bf16" | "f32"  float pools
  "int8"  per-token INT8 K/V with f16 scale pages beside the block table

One frozen object flows launcher -> Gateway -> FleetRouter -> Replica
-> PagedServeEngine, as in the JAX package.  `replicas`, `policy` and
`max_pending` shape the fleet behind the gateway (`repro_torch.fleet`):
the replicas share one card and one copy of the packed weights, each
with its own KV pool, CUDA graphs and stream.  `tp` keeps its field so
configs read the same in both packages, but tensor parallelism is not
in this port yet: tp > 1 raises NotImplementedError.

The resolved config is reported verbatim under `/metrics` (key
"config").
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

PRECISIONS = ("fp", "int8", "int4")
KV_DTYPES = ("auto", "bf16", "f32", "int8")


@dataclass(frozen=True)
class ServeConfig:
    # precision of the hot path
    precision: str = "fp"            # "fp" | "int8" | "int4"
    kv_dtype: str = "auto"           # "auto" | "bf16" | "f32" | "int8"
    quant_group: int = 128           # group size for weight quantization

    # engine geometry
    max_batch: int = 8
    max_seq: int = 256
    page_size: int = 16
    n_pages: Optional[int] = None    # None -> engine sizes the pool
    prefill_chunk: int = 16
    eos_id: Optional[int] = None
    seed: int = 0
    prefix_cache: Optional[bool] = None   # None -> on

    # fleet shape
    replicas: int = 1
    policy: str = "least-loaded"
    max_pending: int = 32

    tp: int = 1

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got "
                f"{self.precision!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got "
                f"{self.kv_dtype!r}")
        if self.tp < 1 or self.replicas < 1:
            raise ValueError(f"tp and replicas must be >= 1, got "
                             f"tp={self.tp}, replicas={self.replicas}")
        if self.tp > 1:
            raise NotImplementedError(
                f"tensor parallelism is not in the PyTorch port yet "
                f"(tp={self.tp})")

    # -- resolution ------------------------------------------------------
    def quantized(self) -> bool:
        return self.precision in ("int8", "int4")

    def weight_bits(self) -> int:
        return {"fp": 16, "int8": 8, "int4": 4}[self.precision]

    def resolved_kv_dtype(self) -> torch.dtype:
        """The torch dtype the paged KV pools are allocated at."""
        kv = self.kv_dtype
        if kv == "auto":
            kv = "int8" if self.quantized() else "bf16"
        return {"bf16": torch.bfloat16, "f32": torch.float32,
                "int8": torch.int8}[kv]

    def as_dict(self) -> dict:
        """JSON-safe resolved view (what `/metrics` reports)."""
        d = dataclasses.asdict(self)
        d["kv_dtype_resolved"] = str(self.resolved_kv_dtype()).replace(
            "torch.", "")
        d["weight_bits"] = self.weight_bits()
        return d
