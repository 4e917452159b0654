"""Quickstart on the PyTorch/CUDA port: train a tiny LM for 30 steps,
checkpoint with DARP write windows, resume, then greedy-decode a few
tokens. The port's counterpart of `examples/quickstart.py`.

  PYTHONPATH=src python examples/quickstart_torch.py                # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain torch
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointConfig  # noqa: E402
from repro_torch.common.config import get_arch  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.dims import make_dims  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig, make_state,  # noqa: E402
                               make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    cfg = get_arch("qwen2.5-3b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(lr=1e-3, warmup_steps=5, total_steps=60)

    def fresh_state():
        gen = torch.Generator(device=device).manual_seed(0)
        return make_state(gen, cfg, dims, ocfg, device=device)

    step_fn = make_train_step(cfg, dims, ocfg, device=device)
    data = SyntheticLMData(cfg.vocab_size, batch=8, seq=32, seed=0)

    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointConfig(directory=d, interval=10, n_banks=4)
        tr = Trainer(TrainerConfig(total_steps=30, ckpt=ck, log_every=5),
                     step_fn, fresh_state(), iter(data), device=device)
        out = tr.run()
        print("train:", out)
        print("loss curve:", [round(h["loss"], 3) for h in tr.history])

        # resume from checkpoint and continue
        tr2 = Trainer(TrainerConfig(total_steps=40, ckpt=ck, log_every=5),
                      step_fn, fresh_state(), iter(data), device=device)
        assert tr2.maybe_restore(), "restore failed"
        print(f"resumed at step {tr2.start_step}")
        out2 = tr2.run()
        print("resumed train:", out2)
        params = tr2.state["params"]

    # greedy decode
    mod = get_model(cfg)
    toks = torch.tensor([[5, 17, 42, 7]], dtype=torch.int32, device=device)
    st = mod.init_decode_state(cfg, dims, 1, 32, device=device)
    pos = 0
    with torch.no_grad():
        for i in range(4):
            logits, st = mod.decode_step(params, st, cfg, dims,
                                         token=toks[:, i], pos=pos)
            pos += 1
        out_toks = []
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
        for _ in range(8):
            out_toks.append(int(tok[0]))
            logits, st = mod.decode_step(params, st, cfg, dims,
                                         token=tok.to(torch.int32), pos=pos)
            pos += 1
            tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
    print("generated tokens:", out_toks)
    return out, out2, out_toks


if __name__ == "__main__":
    main()
