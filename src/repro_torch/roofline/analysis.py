"""Three-term roofline analysis of the port's dry-run records, on the
H100's numbers.

    compute term    = FLOPs / (peak FLOP/s per device)
    memory term     = min_bytes / (HBM bandwidth per device)
    collective term = collective bytes / (link bandwidth per device)

Sources: the dry-run's meta run (`launch/metarun.py`) supplies
per-device FLOPs and bytes; the collectives are the ones the port's
step issues (`launch/dryrun.py::step_collectives`).  `min_bytes` is what
the step must move: the bytes its ops read of its arguments and wrote
into them in place, each argument at most once, and its new results
written once; so the bound is one a device cannot beat.  `hlo_bytes`,
every op's reads and writes along the plain route, unfused, is kept
beside it (`t_memory_by_op`); it is no bound: a fused kernel moves
less.  The JAX package
reads them from XLA's compiled module instead (`cost_analysis()` and
the optimized HLO's all-gather / all-reduce / reduce-scatter ops); the
HLO parser has no counterpart here.

Hardware constants: NVIDIA H100 80GB HBM3 (SXM), 700 W.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

# dense bf16 on the tensor cores, H100 SXM data sheet (NVIDIA H100 80GB
# HBM3, 700 W)
PEAK_FLOPS = 989e12
# HBM3, H100 SXM data sheet (NVIDIA H100 80GB HBM3, 700 W)
HBM_BW = 3.35e12
# NVLink 4, one direction, a mesh axis inside one 8-GPU NVLink domain
# (H100 SXM data sheet: 900 GB/s both ways; NVIDIA H100 80GB HBM3, 700 W)
NVLINK_BW = 450e9
# one 400 Gb/s NIC a GPU, a mesh axis that crosses nodes (NVIDIA H100
# 80GB HBM3, 700 W, in an 8-GPU node with one 400G NIC a GPU)
NIC_BW = 50e9
NODE_GPUS = 8               # GPUs an NVLink domain holds

# the production meshes' 16-wide axes cross nodes
COLLECTIVE_BW = NIC_BW


def axis_bandwidth(size: int) -> float:
    """Bytes/s a device moves over a mesh axis of `size` devices:
    NVLink inside one node, the NIC across nodes."""
    return NVLINK_BW if size <= NODE_GPUS else NIC_BW


def mesh_collective_bw(mesh_shape: Mapping[str, int]) -> float:
    """The slowest link of the mesh's axes wider than one device (the
    collective term's rate); NVLink for a one-device mesh."""
    sizes = [n for n in mesh_shape.values() if n > 1]
    return min((axis_bandwidth(n) for n in sizes), default=NVLINK_BW)


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: float, count: int = 1):
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + count


@dataclass
class Roofline:
    arch: str
    shape_id: str
    kind: str
    mesh: str
    quant: str
    flops: float                  # per device
    hlo_bytes: float              # per device: bytes every op moves
    min_bytes: float              # per device: bytes the step must move
    collective_bytes: float       # per device
    model_flops: float            # 6*N*D (useful) per device
    collective_detail: Dict[str, float] = field(default_factory=dict)
    memory_per_device: Optional[Dict[str, float]] = None
    collective_bw: float = COLLECTIVE_BW

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.min_bytes / HBM_BW

    @property
    def t_memory_by_op(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.collective_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term roofline that is 'useful' work:
        for compute-bound cells this is MFU against the bound time."""
        if self.bound_time == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_time

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape_id, "kind": self.kind,
            "mesh": self.mesh, "quant": self.quant,
            "flops": self.flops, "hlo_bytes": self.hlo_bytes,
            "min_bytes": self.min_bytes,
            "t_memory_by_op": self.t_memory_by_op,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "bound_time": self.bound_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_detail": self.collective_detail,
            "collective_bw": self.collective_bw,
            "memory_per_device": self.memory_per_device,
        }


def model_flops_for(arch_id: str, shape_id: str, n_devices: int,
                    cfg=None, shapes=None) -> float:
    """MODEL_FLOPS per device: 6*N*D for train (2 fwd + 4 bwd), 2*N*D for
    inference, with N = active params (MoE: top_k+shared only) and
    D = tokens processed this step."""
    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.launch.params_count import active_params
    cfg = cfg if cfg is not None else get_config(arch_id)
    seq, batch, kind = (shapes or SHAPES)[shape_id]
    tokens = float(batch) if kind == "decode" else float(seq) * batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_params(cfg) * tokens / n_devices
