"""Roofline probes: two-point layer extrapolation.

The JAX package needs these because XLA's `cost_analysis()` counts a
`lax.scan` body once.  The port's dry-run runs its step on the meta
device, every layer and every time step executed, so a full cell is
never undercounted; the probe is the cheap route to a full-depth number
(two small layer counts instead of all of them) and the layer counts the
card runs a cut cell at:

    run the same (width, seq, batch, mesh, precision) cell at two small
    layer counts  ->  per-layer slope + fixed cost
    ->  total = fixed + n_units_full * slope

Linearity in layer count is exact (identical per-layer work), so the
extrapolation is too.  `time_scan_corrections` is JAX's closed form for
the mLSTM / sLSTM / Mamba2 time-recurrence bodies its probes leave as
scans, kept here equal to JAX's; the port's probe records it and does
not add it (its meta run already counts those steps).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.registry import SHAPES
from repro_torch.models.config import ModelConfig


def probe_variants(cfg: ModelConfig) -> Tuple[Tuple[ModelConfig, int],
                                              Tuple[ModelConfig, int], int]:
    """Two reduced-layer variants (cfg, units) + full unit count.
    A 'unit' is the repeating block (layer, or group for xlstm/zamba)."""
    if cfg.family in ("dense", "moe"):
        n_first = (cfg.moe.first_dense_layers if cfg.moe else 0)
        u_full = cfg.n_layers - n_first
        mk = lambda u: cfg.replace(n_layers=n_first + u, unroll=True)
        return (mk(1), 1), (mk(2), 2), u_full
    if cfg.family == "xlstm":
        per = cfg.ssm.slstm_every
        u_full = cfg.n_layers // per
        mk = lambda g: cfg.replace(n_layers=per * g, unroll=True)
        return (mk(1), 1), (mk(2), 2), u_full
    if cfg.family == "zamba":
        per = cfg.zamba.shared_every
        u_full = cfg.n_layers // per
        tail = cfg.n_layers - u_full * per
        mk = lambda g: cfg.replace(n_layers=per * g + tail, unroll=True)
        return (mk(1), 1), (mk(2), 2), u_full
    raise ValueError(cfg.family)


def time_scan_corrections(cfg: ModelConfig, shape_id: str,
                          n_devices: int) -> Dict[str, float]:
    """Analytic (flops, bytes) for the mLSTM/sLSTM time-recurrence bodies,
    which stay as lax.scan even in unrolled probes.  Per-device numbers.

    mLSTM step/head: C update (f*C + i*vk^T) ~ 4*dh^2 MAC-ish ops, read-
    modify-write of C (dh^2 f32) x3 + Cq matvec 2*dh^2.
    sLSTM step: recurrent gates R_h (d x 4dh blockdiag) = 8*d*dh flops.
    Train multiplies by 4 (fwd + remat-fwd + ~2x bwd).
    """
    seq, batch, kind = SHAPES[shape_id]
    if kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}

    if cfg.family == "zamba":
        # Mamba2 SSD chunk scan: body counted once, trips = seq/chunk.
        from repro_torch.models.ssm import mamba2_dims
        di, nh, ds = mamba2_dims(cfg)
        l = cfg.ssm.chunk
        p_ = cfg.ssm.head_dim
        body_f = batch * (2.0 * l * l * ds + 4.0 * l * l * nh
                          + 2.0 * l * l * nh * p_
                          + 6.0 * l * nh * p_ * ds)
        body_b = batch * (12.0 * l * l * nh            # decay/w tensor rw f32
                          + 8.0 * l * nh * p_          # xs/y
                          + 8.0 * nh * p_ * ds) * 4.0
        trips = float(seq // l - 1)
        f = cfg.n_layers * body_f * trips
        byt = cfg.n_layers * body_b * trips
        if kind == "train":
            f *= 4.0
            byt *= 3.0
        return {"flops": f / n_devices, "bytes": byt / n_devices}

    if cfg.family != "xlstm":
        return {"flops": 0.0, "bytes": 0.0}
    from repro_torch.models.ssm import mlstm_dims, slstm_dims
    di, nh, dh = mlstm_dims(cfg)
    d, nh2, dh2 = slstm_dims(cfg)
    per = cfg.ssm.slstm_every
    n_groups = cfg.n_layers // per

    mlstm_f = batch * nh * (8.0 * dh * dh)
    mlstm_b = batch * nh * (3.0 * dh * dh) * 4.0          # C rmw, f32
    slstm_f = batch * (8.0 * d * dh2) + 12.0 * batch * d
    slstm_b = (3.0 * batch * 4.0 * d + nh2 * dh2 * 4.0 * dh2) * 4.0

    trips = float(seq - 1)
    f = n_groups * ((per - 1) * mlstm_f + slstm_f) * trips
    byt = n_groups * ((per - 1) * mlstm_b + slstm_b) * trips
    if kind == "train":
        f *= 4.0
        byt *= 3.0
    return {"flops": f / n_devices, "bytes": byt / n_devices}


def extrapolate(m1: Dict[str, float], m2: Dict[str, float], u1: int, u2: int,
                u_full: int) -> Dict[str, float]:
    """fixed + slope*units for every shared numeric key."""
    out = {}
    for k in m1:
        if not isinstance(m1[k], (int, float)):
            continue
        slope = (m2[k] - m1[k]) / float(u2 - u1)
        fixed = m1[k] - u1 * slope
        out[k] = fixed + u_full * slope
    return out
