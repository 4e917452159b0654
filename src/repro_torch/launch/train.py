"""Training launcher, port of `repro/launch/train.py`, with `--device`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --steps 100 --batch 8 --seq 64 --ckpt-dir CKPT   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \
      --steps 12 --batch 2 --seq 16 --device cpu                 # plain torch

The weights are random, drawn from a `torch.Generator` seeded by `--seed`
on the chosen device; the data is `SyntheticLMData` from the same seed.
With `--ckpt-dir` the trainer checkpoints every `--ckpt-interval` steps,
its flushes scheduled by `--ckpt-policy`, and resumes from the newest
complete checkpoint there.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.checkpoint import CheckpointConfig
from repro_torch.common.config import get_arch
from repro_torch.core.policy import list_policies
from repro_torch.data import Prefetcher, SyntheticLMData
from repro_torch.models.dims import make_dims
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainerConfig, make_state, \
    make_train_step
from repro_torch.train.step import require_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--ckpt-policy", default="darp",
                    choices=list_policies())
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                     total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = make_state(gen, cfg, dims, ocfg, device=dev)
    step_fn = make_train_step(cfg, dims, ocfg, accum=args.accum, device=dev)
    kind = ("encdec" if cfg.family == "encdec"
            else ("embeds" if cfg.frontend == "embed" else "tokens"))
    data = Prefetcher(iter(SyntheticLMData(
        cfg.vocab_size, batch=args.batch, seq=args.seq, seed=args.seed,
        embed_dim=cfg.d_model, kind=kind)))
    ck = None
    if args.ckpt_dir:
        ck = CheckpointConfig(directory=args.ckpt_dir,
                              interval=args.ckpt_interval,
                              policy=args.ckpt_policy)
    tr = Trainer(TrainerConfig(total_steps=args.steps, ckpt=ck, log_every=10),
                 step_fn, state, data, device=dev)
    if tr.maybe_restore():
        print(f"restored from step {tr.start_step - 1}")
    out = tr.run()
    data.close()
    print(f"device={dev} done:", out)
    for h in tr.history:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} "
              f"dt {h['dt']*1e3:.0f}ms")
    if tr.engine:
        print("ckpt stats:", tr.engine.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
