#!/usr/bin/env python3
"""End-to-end serving example of the PyTorch/CUDA port, the counterpart of
`examples/serve_refresh.py`: a mixed-prompt batch through the
request-lifecycle `EngineCore` with a paged int8 KV cache, comparing
refresh policies.

  all_bank    : stop-the-world page compression (REF_ab analogue)
  round_robin : fixed-order group compression (LPDDR REF_pb analogue)
  darp        : out-of-order + write-window compression (the paper)
  elastic     : demand-elastic postpone (registry extra)
  hira        : refresh-behind-access (registry extra)

Policies resolve by `repro_torch.core.policy` registry name. Tokens
stream through each request handle's callback as they are made; the
summary reports TTFT/TPOT percentiles per policy. The model is the
reduced qwen2-0.5b in float32, weights drawn from seed 0 on the device
(the card unless `--device cpu`); page compression is kernel D there.

  python3 examples/serve_refresh_torch.py [--requests 8] [--new 24]
                                          [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.common.config import get_arch  # noqa: E402
from repro_torch.kvcache import PagedKVConfig  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.dims import make_dims  # noqa: E402
from repro_torch.serving import EngineConfig, EngineCore  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("serve_refresh_torch: torch.cuda.is_available() is False; "
              "pass --device cpu", file=sys.stderr)
        return 2

    cfg = get_arch("qwen2-0.5b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    mod = get_model(cfg)
    params = mod.init(torch.Generator(device=dev).manual_seed(0), cfg, dims,
                      dev)

    # mixed prompt lengths — short chat turns next to a long document
    prompts = [[1 + i] + [2 + (3 * j) % 9 for j in range(2 + (7 * i) % 14)]
               for i in range(args.requests)]

    for pol in ("all_bank", "round_robin", "darp", "elastic", "hira"):
        kv_cfg = PagedKVConfig(
            n_layers=cfg.n_layers, n_kv_heads=dims.n_kv,
            head_dim=cfg.attention.head_dim, page_size=4, n_pages=128,
            n_staging=10, n_groups=4, max_seqs=8)
        ecfg = EngineConfig(
            max_batch=3, policy=pol, refresh_interval=3.0,
            force_threshold=0.99 if pol == "all_bank" else 0.8)
        eng = EngineCore(params, cfg, dims, kv_cfg, ecfg)
        streamed = []
        for i, p in enumerate(prompts):
            eng.submit(p, args.new, rid=i,
                       on_token=lambda h, tok: streamed.append((h.rid, tok)))
        t0 = time.perf_counter()
        eng.run_until_done(max_rounds=800)
        wall = time.perf_counter() - t0
        s = eng.metrics_summary()
        print(f"{pol:12s} tokens={eng.stats['tokens']:4d} "
              f"tok/s={eng.stats['tokens']/wall:6.1f} "
              f"forced_stalls={eng.stats['stall_rounds']:3d} "
              f"compressions={eng.cache.stats['compressions']:3d} "
              f"(forced={eng.cache.stats['forced']}) "
              f"ttft_p50={s['ttft']['p50_ms']}ms "
              f"tpot_p50={s['tpot']['p50_ms']}ms "
              f"streamed={len(streamed)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
