"""The benchmark's weights: every leaf of a configuration, drawn from
the seed on the device in three large calls, in the form it is served
in.

A packed leaf is INT4 as the port serves it: bytes of two 4-bit values
(value + 8, the even row in the low nibble) along the contraction axis,
and one f16 scale per (group, column).  Each value is uniform in
[-7, 7], the range symmetric quantization gives (mean 0: values of mean
-1/2 would add a common direction to every product, which the residual
stream amplifies layer by layer until the model's output no longer
depends on its input); a scale is the leaf's target standard deviation
over 4.32 (the standard deviation of that uniform) times a factor
uniform in [0.8, 1.2].  A float leaf is f32, mean + std * N(0, 1).
The target standard deviations are the configuration's `init` table;
a matrix it does not name follows its `matrix_std` rule (`MATRIX_STD`).

`leaf_table` lists the leaves from the configuration's own sizes, in the
tree the port takes (`DecoderLM.param_specs`); the harness checks the
port's tree against it before a run.  The reference draws the same
leaves again with `draw` and reads them through `dequantize`; it never
sees what the port made of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

UNIFORM_INT4_STD = math.sqrt((15 ** 2 - 1) / 12.0)     # 4.32
ALIGN = 256                                            # bytes a leaf starts on

# the standard deviation of a matrix the `init` table does not name, by
# its contraction size K: 1 / sqrt(K), or the xLSTM reference code's
# small init (its output projections take its "wang" rule, 2 / (layers *
# sqrt(d)), named in the table)
MATRIX_STD = {"fan_in": lambda k: 1.0 / math.sqrt(k),
              "small_init": lambda k: math.sqrt(2.0 / (5 * k))}

# the names the port packs (`repro_torch.quant.ptq.QUANT_KEYS`), frozen
PACKED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed",
          "head", "up_proj", "down_proj", "w_o", "ffn_up", "ffn_down"}


def pick_group(k: int, group: int, shard_hint: int = 16) -> int:
    """The port's group rule, frozen: the largest group <= `group`
    dividing K, preferring a group count divisible by `shard_hint`."""
    best = 0
    for g in range(min(group, k), 7, -1):
        if k % g:
            continue
        if (k // g) % shard_hint == 0:
            return g
        best = best or g
    return best


@dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]      # the float shape
    packed: bool
    table: bool = False         # packed along the last axis (V, K)
    group: int = 0
    std: float = 0.0
    mean: Tuple[float, ...] = (0.0,)

    @property
    def k(self) -> int:
        return self.shape[-1] if self.table else self.shape[-2]

    def data_shape(self) -> Tuple[int, ...]:
        if self.table:
            return (*self.shape[:-1], self.shape[-1] // 2)
        return (*self.shape[:-2], self.shape[-2] // 2, self.shape[-1])

    def scale_shape(self) -> Tuple[int, ...]:
        if self.table:
            return (*self.shape[:-1], self.shape[-1] // self.group)
        return (*self.shape[:-2], self.shape[-2] // self.group,
                self.shape[-1])


def dims(conf: dict) -> dict:
    """The model sizes the harness and the reference use, from the
    configuration file's published keys."""
    m = conf["model"]
    if conf["family"] == "dense":
        d, h = m["hidden_size"], m["num_attention_heads"]
        return dict(family="dense", d=d, layers=m["num_hidden_layers"],
                    heads=h, kv_heads=m["num_key_value_heads"], hd=d // h,
                    ff=m["intermediate_size"], vocab=m["vocab_size"],
                    theta=m["rope_theta"], eps=m["rms_norm_eps"],
                    tied=m["tie_word_embeddings"])
    if conf["family"] == "xlstm":
        d, nh = m["embedding_dim"], m["num_heads"]
        di = int(m["mlstm_proj_factor"] * d)
        return dict(family="xlstm", d=d, layers=m["num_blocks"], heads=nh,
                    per=m["slstm_every"], di=di, dh=di // nh,
                    sdh=d // nh, f_up=int(m["slstm_ffn_proj_factor"] * d),
                    conv=m["conv1d_kernel_size"], vocab=m["vocab_size"],
                    eps=m["norm_eps"], tied=m["tie_weights"])
    raise ValueError(f"family {conf['family']!r} has no leaf table")


def _init(conf: dict, name: str, shape, packed: bool, k: int):
    spec = conf["init"].get(name, {})
    if "std" in spec:
        std = spec["std"]
    elif spec.get("rule") == "wang":       # an output projection
        z = dims(conf)
        std = 2.0 / (z["layers"] * math.sqrt(z["d"]))
    elif len(shape) >= 2 or packed:
        std = MATRIX_STD[conf["init"]["matrix_std"]](k)
    else:
        raise ValueError(f"init: vector leaf {name!r} has no std")
    mean = spec.get("mean", 0.0)
    return std, tuple(mean) if isinstance(mean, list) else (mean,)


def leaf_table(conf: dict) -> List[Leaf]:
    """Every leaf of the configuration, in draw order."""
    z = dims(conf)
    group = conf["serve"]["quant_group"]
    out: List[Leaf] = []

    def add(path, shape, k=None, table=False):
        name = path[-1]
        packed = name in PACKED
        kk = k if k is not None else (shape[-1] if table else shape[-2]
                                      if len(shape) >= 2 else shape[-1])
        std, mean = _init(conf, "scale" if name == "scale" else name,
                          shape, packed, kk)
        g = pick_group(kk, group) if packed else 0
        if packed and (not g or kk % 2):
            raise ValueError(f"{path}: no INT4 group for K={kk}")
        out.append(Leaf(tuple(path), tuple(shape), packed, table, g, std,
                        mean))

    d, V = z["d"], z["vocab"]
    add(("embed",), (V, d), k=d, table=True)
    if not z["tied"]:
        add(("head",), (d, V))
    add(("ln_final", "scale"), (d,))
    if z["family"] == "dense":
        L, H, g, hd, f = z["layers"], z["heads"], z["kv_heads"], z["hd"], \
            z["ff"]
        b = ("blocks",)
        add(b + ("ln_attn", "scale"), (L, d))
        add(b + ("attn", "wq"), (L, d, H * hd))
        add(b + ("attn", "wk"), (L, d, g * hd))
        add(b + ("attn", "wv"), (L, d, g * hd))
        add(b + ("attn", "wo"), (L, H * hd, d))
        add(b + ("attn", "bq"), (L, H * hd), k=d)
        add(b + ("attn", "bk"), (L, g * hd), k=d)
        add(b + ("attn", "bv"), (L, g * hd), k=d)
        add(b + ("ln_ffn", "scale"), (L, d))
        add(b + ("ffn", "w_up"), (L, d, f))
        add(b + ("ffn", "w_down"), (L, f, d))
        add(b + ("ffn", "w_gate"), (L, d, f))
        return out
    G, P = z["layers"] // z["per"], z["per"] - 1
    nh, di, dh, sdh, fu = z["heads"], z["di"], z["dh"], z["sdh"], z["f_up"]
    m = ("mlstm",)
    add(m + ("ln", "scale"), (G, P, d))
    add(m + ("cell", "up_proj"), (G, P, d, 2 * di))
    add(m + ("cell", "conv_w"), (G, P, z["conv"], di), k=z["conv"])
    add(m + ("cell", "conv_b"), (G, P, di), k=z["conv"])
    for name in ("wq", "wk", "wv"):
        add(m + ("cell", name), (G, P, nh, dh, dh))
    add(m + ("cell", "w_if"), (G, P, di, 2 * nh))
    add(m + ("cell", "b_if"), (G, P, 2 * nh), k=di)
    add(m + ("cell", "w_o"), (G, P, di, di))
    add(m + ("cell", "hnorm"), (G, P, di))
    add(m + ("cell", "down_proj"), (G, P, di, d))
    s = ("slstm",)
    add(s + ("ln", "scale"), (G, d))
    add(s + ("cell", "w_gates"), (G, d, 4 * d))
    add(s + ("cell", "r_gates"), (G, nh, sdh, 4 * sdh))
    add(s + ("cell", "b_gates"), (G, 4 * d), k=d)
    add(s + ("cell", "gnorm"), (G, d))
    add(s + ("cell", "ffn_up"), (G, d, 2 * fu))
    add(s + ("cell", "ffn_down"), (G, fu, d))
    return out


@dataclass
class Drawn:
    """One leaf as drawn: `data` and `scales` of a packed leaf, `value`
    of a float one."""
    leaf: Leaf
    data: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None
    value: Optional[torch.Tensor] = None


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def draw(conf: dict, seed: int, device) -> Dict[Tuple[str, ...], Drawn]:
    """Every leaf of `conf` drawn from `seed` on `device`: one call for
    all packed values, one for all scale factors, one for all float
    values; each leaf is a view of them."""
    table = leaf_table(conf)
    packed = [lf for lf in table if lf.packed]
    floats = [lf for lf in table if not lf.packed]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_bytes = sum(_aligned(math.prod(lf.data_shape())) for lf in packed)
    n_scales = sum(math.prod(lf.scale_shape()) for lf in packed)
    n_float = sum(math.prod(lf.shape) for lf in floats)
    nib = torch.randint(1, 16, (n_bytes, 2), dtype=torch.uint8,
                        generator=gen, device=device)
    raw = nib[:, 0] | (nib[:, 1] << 4)
    del nib
    u = torch.rand(n_scales, generator=gen, device=device)
    z = torch.randn(n_float, generator=gen, device=device)
    out: Dict[Tuple[str, ...], Drawn] = {}
    ob = os_ = of = 0
    for lf in packed:
        nb, ns = math.prod(lf.data_shape()), math.prod(lf.scale_shape())
        data = raw[ob:ob + nb].view(lf.data_shape())
        sc = u[os_:os_ + ns].mul_(0.4).add_(0.8).mul_(
            lf.std / UNIFORM_INT4_STD).to(torch.float16)
        out[lf.path] = Drawn(lf, data=data, scales=sc.view(lf.scale_shape()))
        ob += _aligned(nb)
        os_ += ns
    del u
    for lf in floats:
        n = math.prod(lf.shape)
        v = z[of:of + n].view(lf.shape).mul_(lf.std)
        mean = torch.tensor(lf.mean, dtype=torch.float32, device=device)
        v.add_(mean.repeat_interleave(lf.shape[-1] // len(lf.mean)))
        out[lf.path] = Drawn(lf, value=v)
        of += n
    return out


def dequantize(dr: Drawn, index=None) -> torch.Tensor:
    """The f32 weight of a packed leaf (or of `data[index]`, a stacked
    leaf's layer): value times the scale of its group.  Frozen copy of
    the arithmetic the port's INT4 format defines."""
    lf = dr.leaf
    data = dr.data if index is None else dr.data[index]
    scales = dr.scales if index is None else dr.scales[index]
    axis = -1 if lf.table else -2
    p = torch.movedim(data, axis, 0)
    lo = (p & 0xF).to(torch.float32) - 8.0
    hi = (p >> 4).to(torch.float32) - 8.0
    q = torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], *p.shape[1:])
    k = q.shape[0]
    s = torch.movedim(scales, axis, 0).to(torch.float32)
    w = (q.reshape(k // lf.group, lf.group, *q.shape[1:])
         * s[:, None]).reshape(q.shape)
    return torch.movedim(w, 0, axis)
