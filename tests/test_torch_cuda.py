"""CUDA kernels of the PyTorch port vs their plain versions, on the card.

Marked `cuda`: they skip on a machine without a CUDA device (the check
happens inside the `device` fixture, never at import).  This file
imports no JAX, so it runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
      tests/test_torch_cuda.py

Tolerance, f32 throughout: max|kernel - plain| <= 1e-4 * max|plain| +
1e-6.  The kernels sum in another order than the plain versions (split
K, per-warp partials, online softmax), which moves results by a few
f32 ulps of the largest partial sum; TF32 is off for the plain
versions' matrix products.
"""
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cim_gemv import cim_gemv, cim_gemv_plain
from repro_torch.kernels.paged_flash_decode import (paged_decode_plain,
                                                    paged_flash_decode)
from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
from repro_torch.quant.qarray import quantize

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref):
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max()) + 1e-6
    assert err <= tol, (err, tol)


def _gen(seed=0):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 4, 9, 128])
@pytest.mark.parametrize("layout,k,n,group", [
    ("cols", 2048, 2048, 128),
    ("cols", 2048, 256, 128),
    ("cols", 11008, 2048, 86),     # qwen2.5-3b w_down: groups of 86
    ("cols", 172, 68, 43),         # odd group, ragged column tile
    ("table", 2048, 4099, 128),    # (V, K/2) tied table, ragged V
    ("table", 1376, 300, 86),
])
def test_cim_gemv_kernel_matches_plain(device, bits, m, layout, k, n, group):
    g = _gen(1)
    x = torch.randn(m, k, generator=g, device=device)
    if layout == "cols":
        w = quantize(torch.randn(k, n, generator=g, device=device), bits,
                     group)
    else:
        w = quantize(torch.randn(n, k, generator=g, device=device), bits,
                     group, axis=1)
    _close(cim_gemv(x, w), cim_gemv_plain(x, w))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,f,group", [(1, 2048, 11008, 128),
                                         (4, 2048, 11008, 128),
                                         (64, 512, 1376, 128),
                                         (3, 172, 68, 86)])
def test_swiglu_kernel_matches_plain(device, bits, m, k, f, group):
    g = _gen(2)
    x = torch.randn(m, k, generator=g, device=device)
    wg = quantize(torch.randn(k, f, generator=g, device=device) * 0.05,
                  bits, group)
    wu = quantize(torch.randn(k, f, generator=g, device=device) * 0.05,
                  bits, group)
    _close(swiglu_qgemv(x, wg, wu), swiglu_plain(x, wg, wu))


def _paged(device, pools, b=4, g=2, qpk=8, hd=128, ps=16, max_pages=64,
           seed=3):
    gen = _gen(seed)
    n_pages = b * max_pages
    q = torch.randn(b, g, qpk, hd, generator=gen, device=device)
    kf = torch.randn(n_pages, ps, g, hd, generator=gen, device=device)
    vf = torch.randn(n_pages, ps, g, hd, generator=gen, device=device)
    tables = torch.randperm(n_pages, generator=gen, device=device
                            ).reshape(b, max_pages).int()
    lengths = torch.randint(1, max_pages * ps + 1, (b,), generator=gen,
                            device=device).int()
    ks = vs = None
    if pools == "int8":
        ks = (kf.abs().amax(-1).clamp_min(1e-8) / 127).half()
        vs = (vf.abs().amax(-1).clamp_min(1e-8) / 127).half()
        kf = torch.round(kf / ks[..., None].float()).clamp(-127, 127)
        vf = torch.round(vf / vs[..., None].float()).clamp(-127, 127)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "int8": torch.int8}[pools]
    return q, kf.to(dt), vf.to(dt), tables, lengths, ks, vs


@pytest.mark.parametrize("pools", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (200, 0.0), (0, 30.0),
                                        (37, 50.0)])
def test_paged_decode_kernel_matches_plain(device, pools, window, cap):
    q, kp, vp, tables, lengths, ks, vs = _paged(device, pools)
    out = paged_flash_decode(q, kp, vp, tables, lengths, window, cap, ks, vs)
    ref = paged_decode_plain(q, kp, vp, tables, lengths, window, cap, ks, vs)
    _close(out, ref)


def test_paged_decode_kernel_zero_length_lane_is_zero(device):
    q, kp, vp, tables, lengths, ks, vs = _paged(device, "int8", seed=4)
    lengths[2] = 0
    out = paged_flash_decode(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    ref = paged_decode_plain(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    torch.cuda.synchronize()
    assert float(out[2].abs().max()) == 0.0
    keep = lengths > 0
    _close(out[keep], ref[keep])


def test_launches_count_on_the_card_only(device):
    reset_launch_counts()
    x = torch.randn(2, 256, device=device)
    w = quantize(torch.randn(256, 128, device=device), 4, 128)
    cim_gemv(x, w)
    cim_gemv(x.cpu(), w.to("cpu"))
    swiglu_qgemv(x, w, w)
    assert launch_counts() == {"cim_gemv": 1, "swiglu_qgemv": 1,
                               "paged_flash_decode": 0}


def test_wrappers_raise_instead_of_falling_back(device):
    w = quantize(torch.randn(256, 128, device=device), 4, 128)
    with pytest.raises(ValueError):
        cim_gemv(torch.randn(2, 256, device=device).bfloat16(), w)
    with pytest.raises(ValueError):
        cim_gemv(torch.randn(2, 256), w)            # x on the CPU
    w6 = quantize(torch.randn(256, 126, device=device), 4, 128)
    with pytest.raises(ValueError):                  # N not a multiple of 4
        cim_gemv(torch.randn(2, 256, device=device), w6)


def test_serve_step_on_card_matches_cpu(device):
    """A small model through serve_step: kernels on the card vs plain
    versions on the CPU, same weights, int8 KV."""
    from repro_torch.models import DecoderLM, ModelConfig, init_params
    from repro_torch.models.common import tree_to
    from repro_torch.quant.ptq import quantize_params
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=688, vocab=512,
                      head_dim=64, qkv_bias=True, dtype="float32")
    model = DecoderLM(cfg)
    params = quantize_params(init_params(model.param_specs(),
                                         torch.Generator().manual_seed(0),
                                         "cpu", torch.float32), 4, 128)
    outs = {}
    for dev in ("cpu", device):
        p = tree_to(params, dev)
        cache = {"attn": {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                          for k, v in model.paged_cache_specs(
                              8, 16, torch.int8)["attn"].items()}}
        tables = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
        tok = torch.arange(32, device=dev).reshape(2, 16) * 7 % 512
        lengths = torch.zeros(2, dtype=torch.int32, device=dev)
        n_new = torch.tensor([16, 9], dtype=torch.int32, device=dev)
        pre, _ = model.serve_step(p, cache, {"tokens": tok}, tables,
                                  lengths, n_new)
        dec, _ = model.serve_step(p, cache, {"tokens": tok[:, :1]}, tables,
                                  lengths + n_new,
                                  torch.ones(2, dtype=torch.int32,
                                             device=dev))
        outs[str(dev)] = (pre[0].cpu(), pre[1, :9].cpu(), dec.cpu())
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert float((a - b).abs().max()) < 2e-3 * max(1.0,
                                                       float(a.abs().max()))
