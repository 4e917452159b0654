"""Serving launcher: the request-lifecycle EngineCore over the paged int8
KV cache, with registry-resolved maintenance policies and per-request
TTFT/TPOT metrics. Port of `repro/launch/serve.py`, with `--device`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --requests 6 --new 16 --policy darp --mixed          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
      --device cpu                                         # plain torch

The weights are random, drawn from a `torch.Generator` seeded by `--seed`
on the chosen device. Exits non-zero if the engine times out before
draining (livelock is never masked), which makes this the serving smoke.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.common.config import get_arch
from repro_torch.core.policy import list_policies
from repro_torch.kvcache import PagedKVConfig
from repro_torch.models.api import get_model
from repro_torch.models.dims import make_dims
from repro_torch.serving import EngineConfig, EngineCore


def _prompts(n: int, mixed: bool, vocab: int):
    """Deterministic prompt set; --mixed varies lengths (3..32 tokens) the
    way a real arrival mix would."""
    lens = [3 + (11 * i) % 30 for i in range(n)] if mixed else [3] * n
    return [[1 + i] + [(5 * j + i) % max(2, vocab - 1) + 1
                       for j in range(l - 1)]
            for i, l in enumerate(lens)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--policy", default="darp", choices=list_policies())
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8,
                    help="prompt tokens per batched prefill round")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed prompt lengths (3..32 tokens)")
    ap.add_argument("--max-rounds", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config_for(args):
    """(cfg, dims) of `args.arch`, reduced with `--reduced`; f32 params
    and compute, as the reference's launcher."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return cfg, make_dims(cfg, tp=1, param_dtype=torch.float32,
                          compute_dtype=torch.float32)


def init_params(args, cfg, dims):
    """Random weights from a generator seeded by `--seed` on `--device`."""
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    return get_model(cfg).init(gen, cfg, dims, args.device)


def build_engine(args, params=None, **engine_kw):
    """The launcher's engine with its prompts submitted; returns (engine,
    handles). `params` defaults to `init_params`'s; `engine_kw` goes to
    `EngineCore` (e.g. a wrapped `decode_fn`)."""
    cfg, dims = config_for(args)
    if params is None:
        params = init_params(args, cfg, dims)
    kv_cfg = PagedKVConfig(
        n_layers=cfg.n_layers, n_kv_heads=dims.n_kv,
        head_dim=cfg.attention.head_dim, page_size=args.page_size,
        n_pages=256, n_staging=24, n_groups=4, max_seqs=8)
    eng = EngineCore(params, cfg, dims, kv_cfg, EngineConfig(
        max_batch=4, policy=args.policy, max_queue=args.max_queue,
        prefill_chunk=args.chunk), **engine_kw)
    handles = [eng.submit(p, args.new, rid=i)
               for i, p in enumerate(_prompts(args.requests, args.mixed,
                                              cfg.vocab_size))]
    return eng, handles


def main(argv=None):
    args = parse_args(argv)
    eng, handles = build_engine(args)
    t0 = time.perf_counter()
    eng.run_until_done(max_rounds=args.max_rounds)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    summ = eng.metrics_summary()
    print(f"device={eng.device} policy={args.policy} "
          f"tokens={eng.stats['tokens']} "
          f"tok/s={eng.stats['tokens']/wall:.1f} "
          f"forced_stalls={eng.stats['stall_rounds']} "
          f"evictions={eng.stats['evictions']} "
          f"prefill_calls={eng.stats['prefill_calls']} "
          f"decode_calls={eng.stats['decode_calls']}")
    print(f"ttft_ms p50={summ['ttft']['p50_ms']} p99={summ['ttft']['p99_ms']} "
          f"| tpot_ms p50={summ['tpot']['p50_ms']} "
          f"p99={summ['tpot']['p99_ms']} | cache={eng.cache.stats}")
    for h in handles:
        print(f"  rid={h.rid} state={h.state.value} prompt={len(h.prompt)} "
              f"tokens={len(h.tokens)} ttft={h.ttft*1e3:.1f}ms")
    if eng.stats["timed_out"]:
        print("TIMED OUT before draining", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
