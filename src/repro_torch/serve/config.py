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
with its own KV pool, CUDA graphs and stream.  `tp` is the number of
tensor-parallel ranks one engine spans (`repro_torch.dist.shard`): each
rank is a process of a torch.distributed group of `tp` ranks and holds
its slice of the heads, the FFN width, the experts and the vocab, and
of the recurrent cells' heads and state (xlstm, zamba); the engine
serves every family at tp > 1.  At tp > 1 the
steps run eagerly, not as CUDA graphs: the collectives of the gloo
group go through the host, which a graph cannot capture.

The resolved config is reported verbatim under `/metrics` (key
"config"); at tp > 1 it says how the steps run ("steps").
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

PRECISIONS = ("fp", "int8", "int4")
STEPS_AT_TP = ("eager: the tensor-parallel collectives go through the "
               "host (gloo), which a CUDA graph cannot capture")
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
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")

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
        if self.tp > 1:
            d["steps"] = STEPS_AT_TP
        return d
