#!/usr/bin/env python3
"""Where xlstm-1.3b's training step goes, on one NVIDIA GPU.

  python3 tools/xlstm_layer_split.py

Builds one group of the model at full width in f32 (7 mLSTM and 1 sLSTM
layers with the embedding, head and loss; the full model has 6 groups)
with seeded weights, and a batch of 8 x 64 tokens, as the launcher
trains it.  It times three forward + backward calls: the group's loss
against every leaf, and each block kind alone on a (8, 64, 2048) input
against x and the block's leaves.  For each it prints the wall ms
(CUDA events around 2 calls after 1 warm-up; host dispatch included)
beside the device time of the kernels one call ran and their count
(torch.profiler), as one JSON object per call, with the card's name
and power limit.  A wall time far above its device time is host-bound.
Imports nothing of JAX; needs a CUDA device.
"""
import json
import subprocess
import sys
from pathlib import Path

ARCH, LAYERS, BATCH, SEQ = "xlstm-1.3b", 8, 8, 64


def wall_ms(fn, iters=2, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn):
    """(device ms of the kernels one call of fn ran, their count), or
    (None, 0) when the profile holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us += e.time_range.end - e.time_range.start
            n += 1
    return (us / 1e3 if n else None), n


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("xlstm_layer_split: needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import DecoderLM, init_params
    from repro_torch.models.blocks import mlstm_block, slstm_block
    from repro_torch.train.adamw import tree_leaves

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    cfg = get_config(ARCH).replace(dtype="float32", remat=False,
                                   n_layers=LAYERS)
    model = DecoderLM(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(model.param_specs(), gen, device,
                         dtype_override=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(0).items()}
    x = torch.randn(BATCH, SEQ, cfg.d_model, device=device,
                    requires_grad=True)

    def alone(block, tree, depth):
        """fn: forward + backward of the block's first layer on x."""
        lp = {k: {kk: (vv[0, 0] if depth == 2 else vv[0]).detach()
                  .requires_grad_(True) for kk, vv in v.items()}
              for k, v in tree.items()}
        return lambda: torch.autograd.grad(
            block(lp, cfg, x).sum(), [x] + tree_leaves(lp))

    calls = {"group": lambda: torch.autograd.grad(
                 model.loss(params, batch), tree_leaves(params)),
             "mlstm": alone(mlstm_block, params["mlstm"], 2),
             "slstm": alone(slstm_block, params["slstm"], 1)}
    for name, fn in calls.items():
        wall = wall_ms(fn)
        dev, n = device_split(fn)
        print(json.dumps({"arch": ARCH, "call": name, "batch": BATCH,
                          "seq": SEQ, "dtype": "float32",
                          "wall_ms": wall, "device_ms": dev,
                          "kernels": n, "card": card}), flush=True)


if __name__ == "__main__":
    main()
