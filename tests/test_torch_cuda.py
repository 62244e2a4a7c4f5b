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
import re

import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cim_gemv import cim_gemv, cim_gemv_plain, vec_bytes
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.paged_flash_decode import (paged_decode_plain,
                                                    paged_flash_decode,
                                                    paged_flash_verify,
                                                    paged_verify_plain)
from repro_torch.kernels.swiglu_gemv import swiglu_plain, swiglu_qgemv
from repro_torch.quant.qarray import QTensor, quantize

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
@pytest.mark.parametrize("m", [1, 4, 9, 20, 64, 128])
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


def _at_offset(w, nbytes=4):
    """The same packed weight, its data copied `nbytes` past a 16-byte
    boundary: the kernel's 4-byte instantiation."""
    flat = torch.empty(w.data.numel() + nbytes, dtype=w.data.dtype,
                       device=w.data.device)
    data = flat[nbytes:].view(w.data.shape)
    data.copy_(w.data)
    return QTensor(data, w.scales, w.bits, w.group, w.axis, w.orig_shape)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 4, 20])
@pytest.mark.parametrize("layout,k,n,group", [
    ("cols", 2048, 2048, 128),
    ("cols", 11008, 2048, 86),
    ("table", 2048, 4099, 128),
])
def test_cim_gemv_kernel_unaligned_weight_matches_plain(device, bits, m,
                                                        layout, k, n, group):
    g = _gen(4)
    x = torch.randn(m, k, generator=g, device=device)
    if layout == "cols":
        w = quantize(torch.randn(k, n, generator=g, device=device), bits,
                     group)
    else:
        w = quantize(torch.randn(n, k, generator=g, device=device), bits,
                     group, axis=1)
    wo = _at_offset(w)
    row = w.data.shape[1]
    assert vec_bytes(w, row) == 16 and vec_bytes(wo, row) == 4
    out = cim_gemv(x, wo)
    _close(out, cim_gemv_plain(x, w))
    assert torch.equal(out, cim_gemv(x, wo))


@pytest.mark.parametrize("layout,k,n,group", [
    ("cols", 11008, 2048, 86),     # split K: arrival counters, last block
    ("cols", 2048, 256, 128),
    ("table", 2048, 4099, 128),
])
def test_cim_gemv_repeats_bitwise_and_in_a_graph(device, layout, k, n,
                                                 group):
    g = _gen(5)
    x = torch.randn(4, k, generator=g, device=device)
    if layout == "cols":
        w = quantize(torch.randn(k, n, generator=g, device=device), 4, group)
    else:
        w = quantize(torch.randn(n, k, generator=g, device=device), 4, group,
                     axis=1)
    first, second = cim_gemv(x, w), cim_gemv(x, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cim_gemv(x, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cim_gemv(x, w)
    graph.replay()
    third = captured.clone()
    graph.replay()
    torch.cuda.synchronize()
    # the counters were left zero: every call and replay sums the same
    assert torch.equal(first, second)
    assert torch.equal(first, third) and torch.equal(first, captured)
    _close(first, cim_gemv_plain(x, w))


@pytest.mark.parametrize("layout", ["cols", "table"])
def test_cim_gemv_call_is_one_device_kernel(device, layout):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(4, 2048, device=device)
    w = (quantize(torch.randn(2048, 2048, device=device), 4, 128)
         if layout == "cols" else
         quantize(torch.randn(4096, 2048, device=device), 4, 128, axis=1))
    cim_gemv(x, w)                       # counters and library in place
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cim_gemv(x, w)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1, kernels


def _gate_up(device, bits, k, f, group, seed=2):
    g = _gen(seed)
    wg = quantize(torch.randn(k, f, generator=g, device=device) * 0.05,
                  bits, group)
    wu = quantize(torch.randn(k, f, generator=g, device=device) * 0.05,
                  bits, group)
    return g, wg, wu


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,f,group", [(1, 2048, 11008, 128),
                                         (4, 2048, 11008, 128),
                                         (64, 512, 1376, 128),
                                         (3, 172, 68, 86),
                                         (9, 2048, 11008, 128),
                                         (20, 2048, 11008, 128),
                                         (128, 2048, 11008, 128),
                                         (20, 172, 68, 43)])
def test_swiglu_kernel_matches_plain(device, bits, m, k, f, group):
    g, wg, wu = _gate_up(device, bits, k, f, group)
    x = torch.randn(m, k, generator=g, device=device)
    _close(swiglu_qgemv(x, wg, wu), swiglu_plain(x, wg, wu))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 4, 20, 128])
def test_swiglu_kernel_unaligned_weight_matches_plain(device, bits, m):
    g, wg, wu = _gate_up(device, bits, 2048, 11008, 128, seed=6)
    x = torch.randn(m, 2048, generator=g, device=device)
    go, uo = _at_offset(wg), _at_offset(wu)
    assert vec_bytes(wg, 11008) == 16 and vec_bytes(go, 11008) == 4
    out = swiglu_qgemv(x, go, uo)
    _close(out, swiglu_plain(x, wg, wu))
    assert torch.equal(out, swiglu_qgemv(x, go, uo))


@pytest.mark.parametrize("m,k,f,group", [(4, 2048, 11008, 128),
                                         (20, 2048, 11008, 128),
                                         (9, 172, 68, 43)])
def test_swiglu_repeats_bitwise_and_in_a_graph(device, m, k, f, group):
    g, wg, wu = _gate_up(device, 4, k, f, group, seed=7)
    x = torch.randn(m, k, generator=g, device=device)
    first, second = swiglu_qgemv(x, wg, wu), swiglu_qgemv(x, wg, wu)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        swiglu_qgemv(x, wg, wu)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = swiglu_qgemv(x, wg, wu)
    graph.replay()
    third = captured.clone()
    graph.replay()
    torch.cuda.synchronize()
    # the counters were left zero: every call and replay sums the same
    assert torch.equal(first, second)
    assert torch.equal(first, third) and torch.equal(first, captured)
    _close(first, swiglu_plain(x, wg, wu))


@pytest.mark.parametrize("m", [4, 20])
def test_swiglu_call_is_one_device_kernel(device, m, tmp_path):
    """A CUDA graph captured around one call holds one node, the kernel.
    (Counted in the graph: in a long process torch.profiler can drop a
    short profile's kernel events.)"""
    g, wg, wu = _gate_up(device, 4, 2048, 11008, 128, seed=8)
    x = torch.randn(m, 2048, generator=g, device=device)
    swiglu_qgemv(x, wg, wu)              # counters and library in place
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        swiglu_qgemv(x, wg, wu)
    dot = tmp_path / "call.dot"
    graph.debug_dump(str(dot))
    text = dot.read_text()
    nodes = re.findall(r'"graph_\d+_node_\d+"\[[^\]]*?label="\{(\w+)', text)
    assert nodes == ["KERNEL"] and "swiglu_kernel" in text, text


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


def test_paged_decode_kernel_zero_length_lane_matches_plain(device):
    q, kp, vp, tables, lengths, ks, vs = _paged(device, "int8", seed=4)
    lengths[2] = 0
    out = paged_flash_decode(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    ref = paged_decode_plain(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    _close(out, ref)


def _split_lengths(b, g, max_pages, ps):
    """Lengths on and one past the plan's first split boundary, length 1
    and length 0, for a table of max_pages pages."""
    from repro_torch.kernels.paged_flash_decode import decode_plan
    from repro_torch.kernels.split_decode import sm_count
    _, chunk = decode_plan(b, g, max_pages, ps, sm_count(torch.device(
        "cuda")))
    return chunk, [chunk, chunk + 1, 1, 0][:b]


@pytest.mark.parametrize("pools", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,max_pages,window,cap", [
    (4, 64, 0, 0.0), (4, 64, 20, 0.0), (4, 64, 0, 30.0), (1, 256, 0, 0.0),
    (2, 5, 7, 0.0)])
def test_paged_decode_kernel_split_edges_match_plain(device, pools, b,
                                                      max_pages, window,
                                                      cap):
    """Lengths on a split boundary and one past it, length 1, length 0,
    a window across a boundary; batch 1 over 256 pages; every lane
    compared; a second call bitwise equal to the first."""
    q, kp, vp, tables, _, ks, vs = _paged(device, pools, b=b,
                                          max_pages=max_pages, seed=7)
    chunk, lens = _split_lengths(b, q.shape[1], max_pages, kp.shape[1])
    if b == 1:
        lens = [max_pages * kp.shape[1]]
    elif window:
        lens = [2 * chunk + 7, chunk + 5, 1, 0][:b]
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    args = (q, kp, vp, tables, lengths, window, cap, ks, vs)
    out = paged_flash_decode(*args)
    _close(out, paged_decode_plain(*args))
    assert torch.equal(out, paged_flash_decode(*args))


def _verify(device, pools, s, seed=5):
    """Verify-window inputs at qwen2.5-3b attention shapes: lanes whose
    window crosses a page boundary, ends at the table's last row, starts
    at 0, and sits at a long context."""
    q, kp, vp, tables, _, ks, vs = _paged(device, pools, seed=seed)
    b, max_pages, ps = q.shape[0], tables.shape[1], kp.shape[1]
    q = torch.randn(b, s, *q.shape[1:], generator=_gen(seed + 1),
                    device=device)
    lengths = torch.tensor([ps * 3 - 1, max_pages * ps - s, 0, 777],
                           dtype=torch.int32, device=device)
    return q, kp, vp, tables, lengths, ks, vs


@pytest.mark.parametrize("pools", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("s", [1, 2, 5, 9, 24])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (200, 0.0), (0, 30.0),
                                        (1, 0.0)])
def test_paged_verify_kernel_matches_plain(device, pools, s, window, cap):
    """Every lane compared in full; s = 9 and 24 (72 and 192 rows) take
    more than one block of rows.  With window 1 the lanes' windows run
    past the table, so those rows see no key and get the mean of V over
    the table.  A second call is bitwise equal to the first."""
    args = _verify(device, pools, s)
    q, kp, vp, tables, lengths, ks, vs = args
    if window == 1:
        n_keys = tables.shape[1] * kp.shape[1]
        lengths = torch.tensor([n_keys - 2, n_keys - 1, n_keys + 3, 0],
                               dtype=torch.int32, device=device)
    out = paged_flash_verify(q, kp, vp, tables, lengths, window, cap, ks, vs)
    ref = paged_verify_plain(q, kp, vp, tables, lengths, window, cap, ks, vs)
    assert out.shape == q.shape
    _close(out, ref)
    assert torch.equal(out, paged_flash_verify(q, kp, vp, tables, lengths,
                                               window, cap, ks, vs))


@pytest.mark.parametrize("max_pages,nodes", [(64, 2), (1, 1)])
def test_paged_verify_call_is_fold_then_merge(device, max_pages, nodes,
                                              tmp_path):
    """A CUDA graph captured around one call holds the fold kernel, then
    the merge when the plan splits the keys (64 pages), and only the
    fold when it does not (one page)."""
    q, kp, vp, tables, lengths, ks, vs = _verify(device, "int8", 5)
    tables = tables[:, :max_pages].contiguous()
    lengths = lengths.clamp(max=max_pages * kp.shape[1] - 5)
    paged_flash_verify(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        out = paged_flash_verify(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    dot = tmp_path / "call.dot"
    graph.debug_dump(str(dot))
    text = dot.read_text()
    found = re.findall(r'"graph_\d+_node_\d+"\[[^\]]*?label="\{(\w+)', text)
    assert found == ["KERNEL"] * nodes and "verify_kernel" in text, text
    assert ("merge_kernel" in text) == (nodes == 2), text
    graph.replay()
    _close(out, paged_verify_plain(q, kp, vp, tables, lengths, 0, 0.0, ks,
                                   vs))


def test_paged_verify_s1_is_a_decode_step(device):
    q, kp, vp, tables, lengths, ks, vs = _verify(device, "int8", 1)
    lengths[2] = 5                 # decode needs a live token on every lane
    ver = paged_flash_verify(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    dec = paged_flash_decode(q[:, 0].contiguous(), kp, vp, tables,
                             lengths + 1, 0, 0.0, ks, vs)
    _close(ver[:, 0], dec)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,pos,window,cap", [
    (1024, 1023, 0, 0.0), (1024, 300, 0, 0.0), (1024, 0, 0, 0.0),
    (1024, 900, 200, 0.0), (1024, 700, 0, 30.0), (1000, 999, 0, 0.0),
    (1000, 5000, 0, 0.0)])
def test_flash_decode_kernel_matches_plain(device, dtype, S, pos, window,
                                           cap):
    gen = _gen(6)
    q = torch.randn(8, 8, 128, generator=gen, device=device)
    k = torch.randn(8, S, 128, generator=gen, device=device).to(dtype)
    v = torch.randn(8, S, 128, generator=gen, device=device).to(dtype)
    ref = flash_decode_plain(q, k, v, pos, window, cap)
    _close(flash_decode(q, k, v, pos, window, cap), ref)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=device)
    _close(flash_decode(q, k, v, pos_t, window, cap), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bg,S,pos,window,cap", [
    (8, 1024, 47, 0, 0.0), (8, 1024, 48, 0, 0.0), (8, 1024, 103, 20, 0.0),
    (8, 1024, 103, 20, 30.0), (8, 1024, -1, 0, 0.0),
    (8, 1000, 5000, 10, 0.0), (2, 4096, 4095, 0, 0.0), (2, 4096, 0, 0, 0.0),
    (3, 40, 17, 0, 0.0)])
def test_flash_decode_kernel_split_edges_match_plain(device, dtype, bg, S,
                                                     pos, window, cap):
    """pos on and one past a split boundary, a window across one, no
    visible key (the mean of V over all S keys), batch 1 (b*g = 2); a
    second call, with pos on the card, bitwise equal to the first."""
    gen = _gen(8)
    q = torch.randn(bg, 8, 128, generator=gen, device=device)
    k = torch.randn(bg, S, 128, generator=gen, device=device).to(dtype)
    v = torch.randn(bg, S, 128, generator=gen, device=device).to(dtype)
    out = flash_decode(q, k, v, pos, window, cap)
    _close(out, flash_decode_plain(q, k, v, pos, window, cap))
    pos_t = torch.tensor(pos, dtype=torch.int32, device=device)
    assert torch.equal(out, flash_decode(q, k, v, pos_t, window, cap))


@pytest.mark.parametrize("qpk,hd", [(2, 16), (4, 32), (2, 64), (3, 256)])
def test_split_kernels_take_every_instantiated_head_dim(device, qpk, hd):
    gen = _gen(9)
    q = torch.randn(3, qpk, hd, generator=gen, device=device)
    k = torch.randn(3, 100, hd, generator=gen, device=device)
    v = torch.randn(3, 100, hd, generator=gen, device=device)
    _close(flash_decode(q, k, v, 77), flash_decode_plain(q, k, v, 77))
    qp, kp, vp, tables, lengths, ks, vs = _paged(device, "int8", b=3, g=1,
                                                 qpk=qpk, hd=hd,
                                                 max_pages=6, seed=10)
    _close(paged_flash_decode(qp, kp, vp, tables, lengths, 0, 0.0, ks, vs),
           paged_decode_plain(qp, kp, vp, tables, lengths, 0, 0.0, ks, vs))


def test_launches_count_on_the_card_only(device):
    reset_launch_counts()
    x = torch.randn(2, 256, device=device)
    w = quantize(torch.randn(256, 128, device=device), 4, 128)
    cim_gemv(x, w)
    cim_gemv(x.cpu(), w.to("cpu"))
    swiglu_qgemv(x, w, w)
    q, kp, vp, tables, lengths, ks, vs = _verify(device, "int8", 2)
    paged_flash_verify(q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    paged_flash_verify(*[t.cpu() for t in (q, kp, vp, tables, lengths)],
                       0, 0.0, ks.cpu(), vs.cpu())
    kv = torch.randn(2, 64, 32, device=device)
    flash_decode(torch.randn(2, 4, 32, device=device), kv, kv, 10)
    flash_decode(torch.randn(2, 4, 32), kv.cpu(), kv.cpu(), 10)
    assert launch_counts() == {"cim_gemv": 1, "swiglu_qgemv": 1,
                               "paged_flash_decode": 0,
                               "paged_flash_verify": 1, "flash_decode": 1}


def test_wrappers_raise_instead_of_falling_back(device):
    w = quantize(torch.randn(256, 128, device=device), 4, 128)
    with pytest.raises(ValueError):
        cim_gemv(torch.randn(2, 256, device=device).bfloat16(), w)
    with pytest.raises(ValueError):
        cim_gemv(torch.randn(2, 256), w)            # x on the CPU
    tbl = quantize(torch.randn(126, 256, device=device), 4, 128, axis=1)
    with pytest.raises(ValueError):                  # table rows off 4 B
        cim_gemv(torch.randn(2, 256, device=device), _at_offset(tbl, 2))
    q, kp, vp, tables, lengths, ks, vs = _verify(device, "int8", 2)
    with pytest.raises(ValueError):                  # lengths on the CPU
        paged_flash_verify(q, kp, vp, tables, lengths.cpu(), 0, 0.0, ks, vs)
    with pytest.raises(ValueError):                  # f16 pools
        paged_flash_verify(q, kp.half(), vp.half(), tables, lengths)
    with pytest.raises(ValueError):                  # bf16 queries
        paged_flash_verify(q.bfloat16(), kp, vp, tables, lengths, 0, 0.0,
                           ks, vs)
    with pytest.raises(ValueError):                  # hd 48: no kernel
        paged_flash_verify(q[..., :48].contiguous(), kp[..., :48].contiguous(),
                           vp[..., :48].contiguous(), tables, lengths, 0,
                           0.0, ks, vs)
    with pytest.raises(ValueError):                  # q off 16 bytes
        qs = torch.empty(q.numel() + 1, device=device)[1:].view(q.shape)
        paged_flash_verify(qs, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    kv = torch.randn(2, 64, 32, device=device)
    qd = torch.randn(2, 4, 32, device=device)
    with pytest.raises(ValueError):                  # pos on the CPU
        flash_decode(qd, kv, kv, torch.tensor(5, dtype=torch.int32))
    with pytest.raises(ValueError):                  # f16 cache
        flash_decode(qd, kv.half(), kv.half(), 5)
    with pytest.raises(ValueError):                  # k on the CPU
        flash_decode(qd, kv.cpu(), kv, 5)
    with pytest.raises(ValueError):                  # qpk above 16
        flash_decode(torch.randn(2, 17, 32, device=device), kv, kv, 5)
    with pytest.raises(ValueError):                  # hd 48: no kernel
        kv48 = torch.randn(2, 64, 48, device=device)
        flash_decode(torch.randn(2, 4, 48, device=device), kv48, kv48, 5)


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


def test_spec_engine_on_card_runs_every_window_through_verify(device):
    """A small model served with n-gram speculation on the card: the
    stream equals the non-speculative one and every verify call launched
    one `paged_flash_verify` per layer."""
    import numpy as np

    from repro_torch.models import DecoderLM, ModelConfig, init_params
    from repro_torch.serve import PagedServeEngine, ServeConfig, ServeRequest
    from repro_torch.spec import SpecConfig
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=688, vocab=512,
                      head_dim=64, qkv_bias=True, dtype="float32")
    model = DecoderLM(cfg)
    params = init_params(model.param_specs(),
                         torch.Generator(device=device).manual_seed(0),
                         device, torch.float32)
    motif = np.array([5, 77, 301, 9, 42, 1, 260, 13], np.int32)
    outs, engines = [], []
    for spec in (None, SpecConfig(k=4)):
        eng = PagedServeEngine(model, params, ServeConfig(
            precision="int4", max_batch=2, max_seq=64, page_size=16),
            spec=spec, device=device)
        reqs = [ServeRequest(prompt=np.tile(motif, n), max_new_tokens=12)
                for n in (3, 4)]
        reset_launch_counts()
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
        engines.append((eng, launch_counts()))
    eng, counts = engines[1]
    assert outs[0] == outs[1]
    assert eng.verify_calls > 0
    assert counts["paged_flash_verify"] == cfg.n_layers * eng.verify_calls
    assert counts["paged_flash_decode"] == cfg.n_layers * eng.decode_calls


def test_captured_decode_step_replays_bitwise_equal(device):
    """`StepRunner` captures a decode step on its first call (which runs
    eagerly); two replays on the same inputs, in the same pools at the
    same lengths, give bitwise-equal logits and pools, equal to the
    eager call's, and each replay counts one call's kernels."""
    import numpy as np

    from repro_torch.models import DecoderLM, ModelConfig, init_params
    from repro_torch.models.common import tree_to
    from repro_torch.quant.ptq import quantize_params
    from repro_torch.serve import StepRunner
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=688, vocab=512,
                      head_dim=64, qkv_bias=True, dtype="float32")
    model = DecoderLM(cfg)
    params = tree_to(quantize_params(init_params(
        model.param_specs(), torch.Generator().manual_seed(0), "cpu",
        torch.float32), 4, 128), device)
    pools = {"attn": {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                      for k, v in model.paged_cache_specs(
                          8, 16, torch.int8)["attn"].items()}}
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    runner = StepRunner(device)
    assert runner.graphs
    tok = (np.arange(32, dtype=np.int32).reshape(2, 16) * 7) % 512
    runner(model.serve_step, params, pools, tok, tables,
           np.zeros(2, np.int32), np.array([16, 9], np.int32))
    args = (tok[:, :1].copy(), tables, np.array([16, 9], np.int32),
            np.ones(2, np.int32))
    eager = runner(model.serve_step, params, pools, *args).clone()
    reset_launch_counts()
    outs = []
    for _ in range(2):
        logits = runner(model.serve_step, params, pools, *args)
        torch.cuda.synchronize()
        outs.append((logits.clone(), {k: v.clone() for k, v in
                                      pools["attn"].items()}))
    counts = launch_counts()
    assert [st["replays"] for st in runner.steps()] == [0, 2]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][0], eager)
    for k in pools["attn"]:
        assert torch.equal(outs[0][1][k], outs[1][1][k]), k
    L = cfg.n_layers
    assert counts == {"cim_gemv": 2 * (5 * L + 1), "swiglu_qgemv": 2 * L,
                      "paged_flash_decode": 2 * L, "paged_flash_verify": 0,
                      "flash_decode": 0}


# ----------------------------------------------------------------------------
# the shapes of the sliding-window / softcap families and phi3
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["decode", "verify"])
@pytest.mark.parametrize("g,qpk,hd,window,cap,lens", [
    # gemma3: hd 256, lanes shorter than, at, 1 and 300 past the window
    (4, 2, 256, 1024, 0.0, (700, 1024, 1025, 1324)),
    (4, 2, 256, 0, 0.0, (700, 1024, 1025, 1324)),
    # gemma2: hd 128, window 4096 and the attention softcap
    (16, 2, 128, 4096, 50.0, (3000, 4096, 4097, 4396)),
])
def test_split_kernels_with_a_window_shorter_than_the_lane(
        device, kernel, g, qpk, hd, window, cap, lens):
    """INT8 pools; the lanes' keys run past the window, so the splits
    before it fold nothing.  Verify windows of s = 5 end at the decode
    lengths.  Every lane compared in full, a second call bitwise
    equal."""
    ps = 16
    max_pages = -(-max(lens) // ps) + 2
    q, kp, vp, tables, _, ks, vs = _paged(device, "int8", b=4, g=g, qpk=qpk,
                                          hd=hd, max_pages=max_pages,
                                          seed=21)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    if kernel == "decode":
        args = (q, kp, vp, tables, lengths, window, cap, ks, vs)
        out = paged_flash_decode(*args)
        _close(out, paged_decode_plain(*args))
        assert torch.equal(out, paged_flash_decode(*args))
        return
    s = 5
    qv = torch.randn(4, s, g, qpk, hd, generator=_gen(22), device=device)
    args = (qv, kp, vp, tables, lengths - s, window, cap, ks, vs)
    out = paged_flash_verify(*args)
    _close(out, paged_verify_plain(*args))
    assert torch.equal(out, paged_flash_verify(*args))


@pytest.mark.parametrize("m", [1, 4, 20])
@pytest.mark.parametrize("layout,k,n,group", [
    ("cols", 2560, 2048, 80),      # gemma3 wq
    ("cols", 4608, 1024, 96),      # gemma2's K, a slice of its N
    ("cols", 17920, 640, 112),     # phi3 w_down's K
    ("cols", 36864, 512, 128),     # gemma2 w_down's K: 16 splits
    ("table", 2560, 4099, 80),     # gemma3's table rows, ragged V
    ("table", 4608, 2050, 96),     # gemma2's
])
def test_cim_gemv_kernel_at_groups_80_96_112(device, m, layout, k, n,
                                             group):
    g = _gen(23)
    x = torch.randn(m, k, generator=g, device=device)
    if layout == "cols":
        w = quantize(torch.randn(k, n, generator=g, device=device), 4,
                     group)
    else:
        w = quantize(torch.randn(n, k, generator=g, device=device), 4,
                     group, axis=1)
    out = cim_gemv(x, w)
    _close(out, cim_gemv_plain(x, w))
    assert torch.equal(out, cim_gemv(x, w))


@pytest.mark.parametrize("m", [1, 4, 20])
@pytest.mark.parametrize("k,f,group", [(5120, 17920, 80),   # phi3 gate/up
                                       (4608, 1024, 96),
                                       (3584, 1024, 112)])
def test_swiglu_kernel_at_groups_80_96_112(device, m, k, f, group):
    g, wg, wu = _gate_up(device, 4, k, f, group)
    x = torch.randn(m, k, generator=g, device=device)
    out = swiglu_qgemv(x, wg, wu)
    _close(out, swiglu_plain(x, wg, wu))
    assert torch.equal(out, swiglu_qgemv(x, wg, wu))


def test_gemma3_smoke_decode_replay_equals_eager(device):
    """gemma3-smoke (local and global layers, QK-norm, post-block norms,
    the unfused GELU FFN), INT4 weights, INT8 KV, lanes past its window
    of 8: a captured decode step replays bitwise equal to the eager
    call, and counts 7 cim_gemv calls a layer plus the table."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import DecoderLM, init_params
    from repro_torch.quant.ptq import quantize_params
    from repro_torch.serve import StepRunner
    cfg = get_smoke_config("gemma3-4b").replace(dtype="float32",
                                                remat=False)
    model = DecoderLM(cfg)
    params = quantize_params(init_params(
        model.param_specs(), torch.Generator(device=device).manual_seed(0),
        device, torch.float32), 4, 16)
    pools = {"attn": {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                      for k, v in model.paged_cache_specs(
                          8, 16, torch.int8)["attn"].items()}}
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    runner = StepRunner(device)
    tok = (np.arange(32, dtype=np.int32).reshape(2, 16) * 7) % cfg.vocab
    runner(model.serve_step, params, pools, tok, tables,
           np.zeros(2, np.int32), np.array([16, 12], np.int32))
    args = (tok[:, :1].copy(), tables, np.array([16, 12], np.int32),
            np.ones(2, np.int32))
    eager = runner(model.serve_step, params, pools, *args).clone()
    reset_launch_counts()
    logits = runner(model.serve_step, params, pools, *args)
    torch.cuda.synchronize()
    assert torch.equal(logits, eager)
    L = cfg.n_layers
    assert launch_counts() == {"cim_gemv": 7 * L + 1, "swiglu_qgemv": 0,
                               "paged_flash_decode": L,
                               "paged_flash_verify": 0, "flash_decode": 0}


# ----------------------------------------------------------------------------
# MoE: the expert-stack layout, 16 query heads per kv head, gemma2 at INT8
# ----------------------------------------------------------------------------
def _stack(device, bits, E, k, n, group, seed=31):
    g = _gen(seed)
    w = quantize(torch.randn(E, k, n, generator=g, device=device) * 0.05,
                 bits, group, axis=1)
    return g, w


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k,n,group", [(4096, 1536, 128),   # gate / up
                                       (1536, 4096, 96)])   # down
def test_cim_gemv_stack_matches_plain_on_counted_rows(device, bits, k, n,
                                                      group):
    """qwen3-moe's stacks, 128 experts, capacity 8: counts 0, 1, 8 and
    others.  Rows under each count equal the plain version; the rows past
    a count are not read (NaN in x there changes nothing); a second call
    is bitwise equal."""
    E, C = 128, 8
    g, w = _stack(device, bits, E, k, n, group)
    x = torch.randn(E, C, k, generator=g, device=device)
    counts = torch.randint(0, C + 1, (E,), generator=g, device=device)
    counts[:4] = torch.tensor([0, 1, 8, 3], device=device)
    counts = counts.int()
    rows = torch.arange(C, device=device)[None, :] < counts[:, None]
    x = torch.where(rows[..., None], x, float("nan"))
    ref = cim_gemv_plain(torch.nan_to_num(x), w)
    out = cim_gemv(x, w, counts)
    torch.cuda.synchronize()
    assert torch.isfinite(out[rows]).all()
    _close(out[rows], ref[rows])
    assert torch.equal(out[rows], cim_gemv(x, w, counts)[rows])


def test_cim_gemv_stack_all_experts_and_one_launch(device):
    """Every expert at full capacity (a prefill chunk that crowds all
    128), INT4; one call is one kernel, counted once."""
    E, C = 128, 8
    g, w = _stack(device, 4, E, 4096, 1536, 128, seed=32)
    x = torch.randn(E, C, 4096, generator=g, device=device)
    counts = torch.full((E,), C, dtype=torch.int32, device=device)
    reset_launch_counts()
    out = cim_gemv(x, w, counts)
    assert launch_counts()["cim_gemv"] == 1
    _close(out, cim_gemv_plain(x, w))


@pytest.mark.parametrize("pools", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("qpk", [16, 12])
def test_paged_decode_at_16_query_heads_per_kv_head(device, pools, qpk):
    """qwen3-moe's attention: 4 kv heads of 16 query heads, hd 128 (and a
    ragged 12): two blocks a (row, split); split edges, length 0."""
    q, kp, vp, tables, lengths, ks, vs = _paged(device, pools, b=4, g=4,
                                                qpk=qpk, seed=33)
    lengths[3] = 0
    args = (q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    out = paged_flash_decode(*args)
    _close(out, paged_decode_plain(*args))
    assert torch.equal(out, paged_flash_decode(*args))


@pytest.mark.parametrize("s", [1, 5])
def test_paged_verify_at_16_query_heads_per_kv_head(device, s):
    """s * qpk = 80 rows at s = 5: two blocks of rows (z = 2)."""
    _, kp, vp, tables, lengths, ks, vs = _paged(device, "int8", b=4, g=4,
                                                qpk=16, seed=34)
    q = torch.randn(4, s, 4, 16, 128, generator=_gen(35), device=device)
    args = (q, kp, vp, tables, (lengths - s).clamp(min=0), 0, 0.0, ks, vs)
    out = paged_flash_verify(*args)
    _close(out, paged_verify_plain(*args))
    assert torch.equal(out, paged_flash_verify(*args))


def test_flash_decode_at_16_query_heads(device):
    g = _gen(36)
    q = torch.randn(8, 16, 128, generator=g, device=device)
    k = torch.randn(8, 1000, 128, generator=g, device=device)
    v = torch.randn(8, 1000, 128, generator=g, device=device)
    for pos in (999, 517, -1):
        out = flash_decode(q, k, v, pos)
        _close(out, flash_decode_plain(q, k, v, pos))


@pytest.mark.parametrize("m", [4, 20, 64])
@pytest.mark.parametrize("layout,k,n,group", [
    ("cols", 36864, 4608, 96),     # gemma2-27b w_down at INT8: 32 splits
    ("table", 4608, 2050, 96),     # its table's rows (4608 B), 32 a tile
])
def test_cim_gemv_gemma2_int8_widths(device, m, layout, k, n, group):
    g = _gen(37)
    x = torch.randn(m, k, generator=g, device=device)
    if layout == "cols":
        w = quantize(torch.randn(k, n, generator=g, device=device), 8,
                     group)
    else:
        w = quantize(torch.randn(n, k, generator=g, device=device), 8,
                     group, axis=1)
    out = cim_gemv(x, w)
    _close(out, cim_gemv_plain(x, w))
    assert torch.equal(out, cim_gemv(x, w))


def test_qwen3_moe_smoke_decode_replay_equals_eager(device):
    """qwen3-moe-smoke (routed experts through the stack layout, QK-norm,
    8 query heads per kv head), INT4 weights, INT8 KV: a captured decode
    step replays bitwise equal to the eager call and counts 4 + 3
    cim_gemv calls a layer plus the head."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import DecoderLM, init_params
    from repro_torch.quant.ptq import quantize_params
    from repro_torch.serve import StepRunner
    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(
        dtype="float32", remat=False)
    model = DecoderLM(cfg)
    params = quantize_params(init_params(
        model.param_specs(), torch.Generator(device=device).manual_seed(0),
        device, torch.float32), 4, 16)
    pools = {"attn": {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                      for k, v in model.paged_cache_specs(
                          8, 16, torch.int8)["attn"].items()}}
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    runner = StepRunner(device)
    tok = (np.arange(32, dtype=np.int32).reshape(2, 16) * 7) % cfg.vocab
    runner(model.serve_step, params, pools, tok, tables,
           np.zeros(2, np.int32), np.array([16, 12], np.int32))
    args = (tok[:, :1].copy(), tables, np.array([16, 12], np.int32),
            np.ones(2, np.int32))
    eager = runner(model.serve_step, params, pools, *args).clone()
    reset_launch_counts()
    logits = runner(model.serve_step, params, pools, *args)
    torch.cuda.synchronize()
    assert torch.equal(logits, eager)
    L = cfg.n_layers
    assert launch_counts() == {"cim_gemv": 7 * L + 1, "swiglu_qgemv": 0,
                               "paged_flash_decode": L,
                               "paged_flash_verify": 0, "flash_decode": 0}


# ----------------------------------------------------------------------------
# MLA: deepseek-v2-lite-16b's widths and its smoke model
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 4, 20, 64])
@pytest.mark.parametrize("k,n,group", [
    (10944, 2048, 114),    # layer 0's w_down: groups of 114
    (2048, 576, 128),      # w_dkv: nine 64-column tiles
    (2816, 2048, 88),      # the shared experts' down: groups of 88
])
def test_cim_gemv_kernel_at_deepseek_widths(device, bits, m, k, n, group):
    g = _gen(51)
    x = torch.randn(m, k, generator=g, device=device)
    w = quantize(torch.randn(k, n, generator=g, device=device) * 0.02, bits,
                 group)
    out = cim_gemv(x, w)
    _close(out, cim_gemv_plain(x, w))
    assert torch.equal(out, cim_gemv(x, w))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 4, 20, 64])
def test_swiglu_kernel_at_f_10944(device, bits, m):
    """deepseek's leading dense layer: 2048 -> 10944, 85.5 column tiles
    of 128 (the last half full)."""
    g, wg, wu = _gate_up(device, bits, 2048, 10944, 128)
    x = torch.randn(m, 2048, generator=g, device=device)
    out = swiglu_qgemv(x, wg, wu)
    _close(out, swiglu_plain(x, wg, wu))
    assert torch.equal(out, swiglu_qgemv(x, wg, wu))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k,n,group", [(2048, 1408, 128),   # gate / up
                                       (1408, 2048, 88)])   # down
def test_cim_gemv_stack_at_64_experts(device, bits, k, n, group):
    """deepseek's stacks, 64 experts, capacity 8, counts 0 / 1 / 8 and
    others; NaN rows past a count are not read."""
    E, C = 64, 8
    g, w = _stack(device, bits, E, k, n, group, seed=52)
    x = torch.randn(E, C, k, generator=g, device=device)
    counts = torch.randint(0, C + 1, (E,), generator=g, device=device)
    counts[:4] = torch.tensor([0, 1, 8, 3], device=device)
    counts = counts.int()
    rows = torch.arange(C, device=device)[None, :] < counts[:, None]
    x = torch.where(rows[..., None], x, float("nan"))
    ref = cim_gemv_plain(torch.nan_to_num(x), w)
    out = cim_gemv(x, w, counts)
    torch.cuda.synchronize()
    assert torch.isfinite(out[rows]).all()
    _close(out[rows], ref[rows])
    assert torch.equal(out[rows], cim_gemv(x, w, counts)[rows])


def test_deepseek_smoke_decode_replay_equals_eager(device):
    """deepseek-v2-lite-smoke (MLA over bf16 latent pools, a leading
    dense layer, routed and shared experts), INT4 weights: a captured
    decode step replays bitwise equal to the eager call and counts 3
    MLA projections a layer, layer 0's w_down, 6 expert calls a MoE
    layer and the head on cim_gemv, one swiglu_qgemv, no attention
    kernel."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import DecoderLM, init_params
    from repro_torch.quant.ptq import quantize_params
    from repro_torch.serve import StepRunner
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    cfg = get_smoke_config("deepseek-v2-lite-16b").replace(
        dtype="float32", remat=False)
    model = DecoderLM(cfg)
    params = quantize_params(init_params(
        model.param_specs(), torch.Generator(device=device).manual_seed(0),
        device, torch.float32), 4, 16)
    pools = {name: {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                    for k, v in p.items()}
             for name, p in model.paged_cache_specs(8, 16,
                                                    torch.bfloat16).items()}
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    runner = StepRunner(device)
    tok = (np.arange(32, dtype=np.int32).reshape(2, 16) * 7) % cfg.vocab
    runner(model.serve_step, params, pools, tok, tables,
           np.zeros(2, np.int32), np.array([16, 12], np.int32))
    args = (tok[:, :1].copy(), tables, np.array([16, 12], np.int32),
            np.ones(2, np.int32))
    eager = runner(model.serve_step, params, pools, *args).clone()
    reset_launch_counts()
    logits = runner(model.serve_step, params, pools, *args)
    torch.cuda.synchronize()
    assert torch.equal(logits, eager)
    assert torch.isfinite(logits).all()
    L, n_moe = cfg.n_layers, cfg.n_layers - cfg.moe.first_dense_layers
    assert launch_counts() == {"cim_gemv": 3 * L + 1 + 6 * n_moe + 1,
                               "swiglu_qgemv": 1, "paged_flash_decode": 0,
                               "paged_flash_verify": 0, "flash_decode": 0}


# ----------------------------------------------------------------------------
# the recurrent and hybrid families: xlstm-1.3b and zamba2-7b
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("pools", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("b,max_pages", [(4, 64), (1, 256), (2, 5)])
def test_paged_decode_at_head_dim_112(device, pools, b, max_pages):
    """zamba2-7b's shared attention: 32 kv heads of one query head each,
    hd 112 (a lane's p . v dims are ceil(112 / 32) = 4, 28 lanes busy;
    int8 q . k in 8-byte loads): lengths on and one past a split
    boundary, 1 and 0; batch 1 over 256 pages; bitwise twice."""
    q, kp, vp, tables, _, ks, vs = _paged(device, pools, b=b, g=32, qpk=1,
                                          hd=112, max_pages=max_pages,
                                          seed=61)
    chunk, lens = _split_lengths(b, 32, max_pages, kp.shape[1])
    if b == 1:
        lens = [max_pages * kp.shape[1]]
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    args = (q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    out = paged_flash_decode(*args)
    _close(out, paged_decode_plain(*args))
    assert torch.equal(out, paged_flash_decode(*args))


@pytest.mark.parametrize("s", [1, 5])
def test_paged_verify_and_flash_decode_at_head_dim_112(device, s):
    """The two kernels sharing `split_decode.cuh` take hd 112 too (one
    HEAD_DIMS list): verify windows of lanes at 0, 1 and past a page;
    flash_decode over a contiguous cache."""
    _, kp, vp, tables, _, ks, vs = _paged(device, "int8", b=4, g=32, qpk=1,
                                          hd=112, max_pages=8, seed=62)
    q = torch.randn(4, s, 32, 1, 112, generator=_gen(63), device=device)
    lengths = torch.tensor([0, 1, 37, 128 - s], dtype=torch.int32,
                           device=device)
    args = (q, kp, vp, tables, lengths, 0, 0.0, ks, vs)
    out = paged_flash_verify(*args)
    _close(out, paged_verify_plain(*args))
    assert torch.equal(out, paged_flash_verify(*args))
    gen = _gen(64)
    qf = torch.randn(8, 1, 112, generator=gen, device=device)
    k = torch.randn(8, 300, 112, generator=gen, device=device)
    v = torch.randn(8, 300, 112, generator=gen, device=device)
    _close(flash_decode(qf, k, v, 211), flash_decode_plain(qf, k, v, 211))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 4, 64])
@pytest.mark.parametrize("k,n,group", [
    (2048, 8192, 128),     # xlstm up_proj
    (4096, 4096, 128),     # xlstm w_o
    (2048, 5460, 128),     # xlstm ffn_up
    (2730, 2048, 105),     # xlstm ffn_down: odd groups of 105
    (2048, 50304, 128),    # xlstm head
    (3584, 14576, 112),    # zamba in_proj
    (7168, 3584, 112),     # zamba out_proj
    (3584, 3584, 112),     # zamba q/k/v/o and the LoRA out_proj
    (3584, 32000, 112),    # zamba head
])
def test_cim_gemv_kernel_at_recurrent_widths(device, bits, m, k, n, group):
    g = _gen(65)
    w = quantize(torch.randn(k, n, generator=g, device=device) * 0.02,
                 bits, group)
    x = torch.randn(m, k, generator=g, device=device)
    out = cim_gemv(x, w)
    _close(out, cim_gemv_plain(x, w))
    assert torch.equal(out, cim_gemv(x, w))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 4, 64])
def test_cim_gemv_stack_takes_the_mlstm_head_wise_projections(device, bits,
                                                             rows):
    """xlstm-1.3b's q/k/v: 4 heads of (1024, 1024) in groups of 64, each
    head an expert holding every row (counts all full)."""
    g, w = _stack(device, bits, 4, 1024, 1024, 64, seed=66)
    x = torch.randn(4, rows, 1024, generator=g, device=device)
    counts = torch.full((4,), rows, dtype=torch.int32, device=device)
    out = cim_gemv(x, w, counts)
    _close(out, cim_gemv_plain(x, w))
    assert torch.equal(out, cim_gemv(x, w, counts))


@pytest.mark.parametrize("m", [1, 4, 20])
def test_swiglu_kernel_at_zamba_width(device, m):
    g = _gen(67)
    wg = quantize(torch.randn(3584, 14336, generator=g, device=device)
                  * 0.02, 4, 112)
    wu = quantize(torch.randn(3584, 14336, generator=g, device=device)
                  * 0.02, 4, 112)
    x = torch.randn(m, 3584, generator=g, device=device)
    out = swiglu_qgemv(x, wg, wu)
    _close(out, swiglu_plain(x, wg, wu))
    assert torch.equal(out, swiglu_qgemv(x, wg, wu))


@pytest.mark.parametrize("arch,per_step", [
    # 3 mLSTM layers x (up, w_o, down + 3 head-wise stack calls), the
    # sLSTM layer's ffn_up (its ffn_down, K = 85, has no group dividing
    # K and stays float, as in the JAX package), the head
    ("xlstm-1.3b", {"cim_gemv": 3 * 6 + 1 + 1, "swiglu_qgemv": 0,
                    "paged_flash_decode": 0}),
    # 5 Mamba2 layers x (in_proj, out_proj), 2 shared-block invocations
    # x (q, k, v, o, LoRA out_proj, w_down), the head
    ("zamba2-7b", {"cim_gemv": 5 * 2 + 2 * 6 + 1, "swiglu_qgemv": 2,
                   "paged_flash_decode": 2}),
])
def test_recurrent_smoke_decode_replay_equals_eager(device, arch, per_step):
    """The smoke config, INT4 (xlstm's sLSTM ffn_up has 170 columns: the
    kernel's byte copies, N % 4 != 0): a captured decode step, replayed
    from the same arena state as its eager call, gives bitwise the same
    logits and the same new state; the arena's tensors keep their
    addresses; the launches of one call are the ones listed."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import DecoderLM, init_params
    from repro_torch.models.common import map_specs
    from repro_torch.quant.ptq import quantize_params
    from repro_torch.serve import StepRunner
    cfg = get_smoke_config(arch).replace(dtype="float32", remat=False)
    model = DecoderLM(cfg)
    params = quantize_params(init_params(
        model.param_specs(), torch.Generator(device=device).manual_seed(0),
        device, torch.float32), 4, 16)
    specs = model.decode_state_specs(2, 8, 16, torch.int8)
    state = {}
    for half in ("paged", "arena"):
        state.update(map_specs(lambda s: torch.zeros(
            s.shape, dtype=s.dtype, device=device), specs[half]))

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])
    ptrs = [x.data_ptr() for x in leaves(state)]
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    runner = StepRunner(device)
    tok = (np.arange(32, dtype=np.int32).reshape(2, 16) * 7) % cfg.vocab
    runner(model.serve_step, params, state, tok, tables,
           np.zeros(2, np.int32), np.array([16, 12], np.int32))
    args = (tok[:, :1].copy(), tables, np.array([16, 12], np.int32),
            np.ones(2, np.int32))
    before = [x.clone() for x in leaves(state)]
    eager = runner(model.serve_step, params, state, *args).clone()
    after = [x.clone() for x in leaves(state)]
    for x, b in zip(leaves(state), before):
        x.copy_(b)
    reset_launch_counts()
    logits = runner(model.serve_step, params, state, *args)
    torch.cuda.synchronize()
    assert torch.equal(logits, eager) and torch.isfinite(logits).all()
    assert all(torch.equal(x, a) for x, a in zip(leaves(state), after))
    assert [x.data_ptr() for x in leaves(state)] == ptrs
    got = launch_counts()
    assert {k: got[k] for k in per_step} == per_step


# ----------------------------------------------------------------------------
# cim_gemv at any N (a ragged last column group, byte copies)
# ----------------------------------------------------------------------------
def _ragged_weight(device, bits, layout, k, n, group, e=3, seed=41):
    g = _gen(seed)
    if layout == "cols":
        return quantize(torch.randn(k, n, generator=g, device=device), bits,
                        group)
    return quantize(torch.randn(e, k, n, generator=g, device=device), bits,
                    group, axis=1)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 4, 20])
@pytest.mark.parametrize("n", [1, 3, 6, 170, 171])
@pytest.mark.parametrize("layout", ["cols", "stack"])
def test_cim_gemv_kernel_at_any_n(device, bits, m, n, layout):
    """N not a multiple of 4 (odd N too: scale rows not 4-byte aligned),
    K = 2048 so a column tile splits K over several blocks, both layouts;
    bitwise repeatable; the split plan has more than one split."""
    from repro_torch.kernels.cim_gemv import split_plan, stack_plan
    k = 2048
    w = _ragged_weight(device, bits, layout, k, n, 128)
    stored = k // (2 if bits == 4 else 1)
    g = _gen(42)
    if layout == "cols":
        x = torch.randn(m, k, generator=g, device=device)
        assert split_plan("cols", m, stored, n, bits).splits > 1
        assert vec_bytes(w, n) == (16 if n % 16 == 0 else
                                   4 if n % 4 == 0 else 1)
        out = cim_gemv(x, w)
        _close(out, cim_gemv_plain(x, w))
        assert torch.equal(out, cim_gemv(x, w))
        return
    e = w.data.shape[0]
    x = torch.randn(e, m, k, generator=g, device=device)
    counts = torch.tensor([m, 0, max(1, m // 2)], dtype=torch.int32,
                          device=device)
    assert stack_plan(m, stored, n, bits, e).splits >= 1
    out = cim_gemv(x, w, counts)
    ref = cim_gemv_plain(x, w)
    torch.cuda.synchronize()
    for ei, c in enumerate(counts.tolist()):
        if c:
            _close(out[ei, :c], ref[ei, :c])
    assert torch.equal(out[0], cim_gemv(x, w, counts)[0])


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cim_gemv_kernel_on_weights_off_4_bytes(device, bits, offset):
    """A packed weight whose base is not 4-byte aligned (N % 4 == 0):
    the byte-copy instantiation."""
    g = _gen(43)
    w = quantize(torch.randn(2048, 256, generator=g, device=device), bits,
                 128)
    wo = _at_offset(w, offset)
    assert vec_bytes(wo, 256) == 1
    x = torch.randn(4, 2048, generator=g, device=device)
    _close(cim_gemv(x, wo), cim_gemv_plain(x, w))


# ----------------------------------------------------------------------------
# engines sharing the card: streams, captures, counts, arrival counters
# ----------------------------------------------------------------------------
def _small_model(device):
    from repro_torch.models import DecoderLM, ModelConfig, init_params
    from repro_torch.models.common import tree_to
    from repro_torch.quant.ptq import quantize_params
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=688, vocab=512,
                      head_dim=64, qkv_bias=True, dtype="float32")
    model = DecoderLM(cfg)
    params = tree_to(quantize_params(init_params(
        model.param_specs(), torch.Generator().manual_seed(0), "cpu",
        torch.float32), 4, 128), device)
    return model, params


def _engine(model, params, device):
    from repro_torch.serve import PagedServeEngine, ServeConfig
    return PagedServeEngine(model, params, ServeConfig(
        precision="int4", max_batch=4, max_seq=64, page_size=16),
        device=device)


def _requests(seed, n=6):
    import numpy as np

    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(prompt=rng.integers(0, 512, int(ln)).astype(
        np.int32), max_new_tokens=10, rid=i)
        for i, ln in enumerate(rng.integers(5, 40, size=n))]


def _run_threads(jobs):
    """Run each job on its own thread, all released at once; re-raise
    the first error.  Returns each job's thread."""
    import threading
    start = threading.Barrier(len(jobs))
    errors = []

    def wrap(job):
        start.wait(30)
        try:
            job()
        except BaseException as e:      # the test re-raises it
            errors.append(e)
    threads = [threading.Thread(target=wrap, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return threads


def _per_call(model, s):
    L = model.cfg.n_layers
    return {"cim_gemv": 5 * L + 1, "swiglu_qgemv": L,
            "paged_flash_decode": L if s == 1 else 0,
            "paged_flash_verify": 0, "flash_decode": 0}


def _expected(model, eng):
    pre, dec = _per_call(model, 16), _per_call(model, 1)
    return {k: pre[k] * eng.prefill_calls + dec[k] * eng.decode_calls
            for k in pre}


def test_two_engines_on_two_threads_give_their_solo_streams(device):
    """Two engines sharing one copy of the weights step at once on two
    threads, as CUDA graphs on their own streams: each gives the streams
    it gives alone, each thread's launch counts are exactly its engine's
    calls times the per-call counts, every step was captured once."""
    from repro_torch.kernels import thread_launch_counts
    model, params = _small_model(device)
    solo = []
    for seed in (1, 2):
        reqs = _requests(seed)
        _engine(model, params, device).run(reqs)
        solo.append([r.out_tokens for r in reqs])
    engines = [_engine(model, params, device) for _ in range(2)]
    assert engines[0].stream != engines[1].stream
    runs = [_requests(1), _requests(2)]
    reset_launch_counts()
    threads = _run_threads([lambda e=e, r=r: e.run(r)
                            for e, r in zip(engines, runs)])
    torch.cuda.synchronize()
    for eng, reqs, want, t in zip(engines, runs, solo, threads):
        assert [r.out_tokens for r in reqs] == want
        assert thread_launch_counts(t) == _expected(model, eng)
        steps = eng.runner.steps()
        assert len(steps) == 2 and all(s["captured"] for s in steps)
    assert launch_counts() == {k: sum(_expected(model, e)[k]
                                      for e in engines)
                               for k in launch_counts()}


def test_capture_on_one_thread_while_another_replays(device):
    """Engine A, its graphs captured, replays on one thread while engine
    B captures its own on another: no capture error, both streams as
    alone, B's graphs hold exactly one call's launches."""
    from repro_torch.kernels import thread_launch_counts
    model, params = _small_model(device)
    ref = []
    for seed in (3, 4):
        reqs = _requests(seed, n=8)
        _engine(model, params, device).run(reqs)
        ref.append([r.out_tokens for r in reqs])
    a, b = _engine(model, params, device), _engine(model, params, device)
    a.run(_requests(5, n=4))                       # A captures first
    a_calls = (a.prefill_calls, a.decode_calls)
    runs = [_requests(3, n=8), _requests(4, n=8)]
    reset_launch_counts()
    threads = _run_threads([lambda: a.run(runs[0]), lambda: b.run(runs[1])])
    torch.cuda.synchronize()
    assert [r.out_tokens for r in runs[0]] == ref[0]
    assert [r.out_tokens for r in runs[1]] == ref[1]
    for st in b.runner.steps():
        s = st["shape"][1]
        assert st["captured"]
        assert st["launches_per_call"] == _per_call(model, s)
    pre, dec = _per_call(model, 16), _per_call(model, 1)
    assert thread_launch_counts(threads[0]) == {
        k: pre[k] * (a.prefill_calls - a_calls[0])
        + dec[k] * (a.decode_calls - a_calls[1]) for k in pre}
    assert thread_launch_counts(threads[1]) == _expected(model, b)


@pytest.mark.parametrize("shape", [(11008, 2048, 86), (2048, 256, 128)])
def test_arrival_counters_are_per_stream_and_left_zero(device, shape):
    """Calls on two streams use two sets of arrival counters (different
    addresses), and each is zero after its call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.cim_gemv import _counters, split_plan
    from repro_torch.kernels.swiglu_gemv import swiglu_qgemv as sw
    k, n, group = shape
    g = _gen(44)
    w = quantize(torch.randn(k, n, generator=g, device=device), 4, group)
    x = torch.randn(4, k, generator=g, device=device)
    assert split_plan("cols", 4, k // 2, n, 4).splits > 1
    s1, s2 = torch.cuda.Stream(device), torch.cuda.Stream(device)
    outs, ptrs = [], []
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append(cim_gemv(x, w))
            sw(x, w, w)
            ptrs.append((_counters(device, stream=_build.stream_handle())
                         .data_ptr(),
                         _counters(device, "swiglu_qgemv",
                                   _build.stream_handle()).data_ptr()))
    torch.cuda.synchronize()
    assert ptrs[0][0] != ptrs[1][0] and ptrs[0][1] != ptrs[1][1]
    assert len({p for pair in ptrs for p in pair}) == 4
    for s in (s1, s2):
        for kern in ("cim_gemv", "swiglu_qgemv"):
            assert int(_counters(device, kern, s.cuda_stream).abs().sum()) \
                == 0
    assert torch.equal(outs[0], outs[1])
