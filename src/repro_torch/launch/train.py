"""Training launcher for the PyTorch port (the counterpart of
`repro.launch.train`).

  python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \
      --device cpu --steps 100 --ckpt-dir ck --resume
  python -m repro_torch.launch.train --arch qwen2.5-3b --steps 4  # card
  python -m repro_torch.launch.train --arch musicgen-medium --layers 4
  python -m repro_torch.launch.train --arch xlstm-1.3b --steps 4
  python -m repro_torch.launch.train --arch zamba2-7b --layers 27

The JAX launcher's flags, plus `--device` (the card unless `--device
cpu`; with no card it stops instead of falling back to the CPU) and
`--layers` (cut the depth: zamba2-7b's 81 layers hold 111 GB at 16 B a
parameter, 27 fit one card).  Every family trains, the recurrent ones
(xlstm, zamba) included.  Activations in f32, remat off, a cosine
schedule with 10 warm-up steps, synthetic Markov-chain data; the archs
that take embeddings (pixtral-12b, musicgen-medium) are fed the
`FrontendStub` of the same token stream.  Prints the same `[train]`
lines as the JAX launcher.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = full)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preempt-flag", default=None)
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, FrontendStub, SyntheticLM
    from repro_torch.models import DecoderLM
    from repro_torch.train import (AdamW, TrainConfig, Trainer,
                                   cosine_schedule)

    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(dtype="float32", remat=False)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    model = DecoderLM(cfg)
    print(f"[train] {cfg.name}: {model.n_params()/1e6:.1f}M params")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    feed = data if cfg.embed_inputs else FrontendStub(data, cfg.d_model)
    opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps))
    tr = Trainer(model, opt, feed,
                 TrainConfig(steps=args.steps, log_every=10, ckpt_every=50,
                             ckpt_dir=args.ckpt_dir,
                             preempt_flag=args.preempt_flag,
                             microbatches=args.microbatches),
                 event_hook=lambda e: print(f"  {e.kind} @{e.step} "
                                            f"{e.payload}"),
                 device=device)
    out = tr.run(resume=args.resume)
    print(f"[train] done @step {out['step']}  loss {out['losses'][-1]:.3f} "
          f"(floor {data.bigram_entropy():.3f})")
    return out


if __name__ == "__main__":
    main()
