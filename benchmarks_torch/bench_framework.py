"""Framework-side benchmarks of the PyTorch/CUDA port, the counterparts of
`benchmarks/bench_framework.py`'s benches.

bench_darp_ckpt    : trainer step-time overhead: synchronous all-bank
                     checkpoint flushes vs DARP write-window flushes vs no
                     checkpoint, on the reduced qwen2.5-3b.

bench_serving      : serving policies by registry name (all_bank /
                     round_robin / darp / elastic / hira) through the
                     legacy `ServingEngine` shim: throughput, forced
                     stalls, compressions.
bench_serving_lifecycle : `EngineCore` under a mixed-prompt batch with
                     chunked prefill: TTFT/TPOT percentiles, stall and
                     eviction counts, the prefill/decode call split.
                     Raises on an engine timeout.
bench_serving_cosim : the serving <-> DRAM co-sim sweep: one scenario's
                     KV page traffic replayed through `DramSim` per
                     refresh policy; tick-space TTFT/TPOT p99 orderings
                     and the bit-identical replay pin.
bench_sarp_bytes   : derived HBM traffic of fused vs serial paged attention
                     (plain arithmetic, the same numbers as the reference).
bench_kernel_micro : us a call of the plain PyTorch versions
                     (`repro_torch.kernels.ref`) at the reference's three
                     shapes, beside the CUDA kernels through
                     `repro_torch.kernels.ops` (`*_kernel_us`).

The serving benches take `device` (None: the card). Their models are the
reduced qwen2-0.5b in float32 with weights drawn from seed 0 on that
device: other numbers than the reference's JAX draws, so other tokens,
but the same scheduling — the engine generates `max_new` tokens a
request (it has no stop token) and decides maintenance, stalls and
evictions from rounds and page occupancy, never from token values. What
differs from the reference's artifacts is the wall clock (`wall_s`,
`tok_per_s`, the `*_ms` percentiles).
"""
from __future__ import annotations

import time

import numpy as np
import torch


def _serving_model(device):
    """The reduced qwen2-0.5b in float32 on `device` (None: the card),
    weights from seed 0: (params, cfg, dims)."""
    from repro_torch.common.config import get_arch
    from repro_torch.models.api import get_model
    from repro_torch.models.dims import make_dims
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the serving benches were asked to run on the "
                           "card but torch.cuda.is_available() is False")
    cfg = get_arch("qwen2-0.5b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    return get_model(cfg).init(gen, cfg, dims, dev), cfg, dims


def bench_darp_ckpt(steps: int = 40, interval: int = 8, device=None) -> dict:
    """The reference's `bench_darp_ckpt` on the port: `steps` trainer steps
    of the reduced qwen2.5-3b in float32 (batch 8 x 64 tokens) on `device`
    (None: the card), checkpointing every `interval` steps into 8 banks
    flushed under DARP, all at once (`all_bank`), or not at all. `flushes`
    depends only on the schedule, so it equals the reference's; the rest
    is wall clock (steps 2 onward)."""
    import tempfile
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.common.config import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.train import (Trainer, TrainerConfig, make_state,
                                   make_train_step)

    dev = torch.device("cuda" if device is None else device)
    cfg = get_arch("qwen2.5-3b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    step_fn = make_train_step(cfg, dims, ocfg, device=dev)
    data = SyntheticLMData(cfg.vocab_size, batch=8, seq=64, seed=0)
    out = {}
    for policy in ("darp", "all_bank", None):
        gen = torch.Generator(device=dev).manual_seed(0)
        state = make_state(gen, cfg, dims, ocfg, device=dev)
        with tempfile.TemporaryDirectory() as d:
            ck = None
            if policy is not None:
                ck = CheckpointConfig(directory=d, interval=interval,
                                      n_banks=8, policy=policy)
            tr = Trainer(TrainerConfig(total_steps=steps, ckpt=ck,
                                       log_every=1000),
                         step_fn, state, iter(data), device=dev)
            t0 = time.perf_counter()
            tr.run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            times = np.array(tr.step_times[2:])
            out[policy or "no_ckpt"] = {
                "wall_s": round(wall, 2),
                "mean_step_ms": round(float(times.mean() * 1e3), 2),
                "p99_step_ms": round(float(np.percentile(times, 99) * 1e3), 2),
                "flushes": tr.engine.stats["flushes"] if tr.engine else 0,
            }
    base = out["no_ckpt"]["mean_step_ms"]
    for k in ("darp", "all_bank"):
        out[k]["overhead_pct"] = round(
            100 * (out[k]["mean_step_ms"] / base - 1), 1)
    return out


def bench_serving(n_requests: int = 6, max_new: int = 24,
                  policies: tuple = ("all_bank", "round_robin", "darp",
                                     "elastic", "hira"),
                  device=None) -> dict:
    """Sweep the legacy `ServingEngine` shim over a policy axis (it
    doubles as the compat regression for that surface)."""
    import warnings
    from repro_torch.kvcache import PagedKVConfig
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    params, cfg, dims = _serving_model(device)
    out = {}
    for pol in policies:
        kv_cfg = PagedKVConfig(
            n_layers=cfg.n_layers, n_kv_heads=dims.n_kv,
            head_dim=cfg.attention.head_dim, page_size=4, n_pages=128,
            n_staging=10, n_groups=4, max_seqs=8)
        scfg = ServeConfig(max_batch=3, policy=pol,
                           refresh_interval=3.0, max_compress_per_round=1,
                           force_threshold=0.99 if pol == "all_bank" else 0.8)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = ServingEngine(params, cfg, dims, kv_cfg, scfg)
        for i in range(n_requests):
            eng.submit(Request(prompt=[1 + i, 2, 3, 4], max_new=max_new,
                               rid=i))
        t0 = time.perf_counter()
        eng.run_until_done(max_rounds=600)
        wall = time.perf_counter() - t0
        out[pol] = {
            "wall_s": round(wall, 2),
            "tokens": eng.stats["tokens"],
            "tok_per_s": round(eng.stats["tokens"] / wall, 1),
            "forced_stalls": eng.stats["stall_rounds"],
            "compressions": eng.cache.stats["compressions"]
                            + eng.cache.stats["forced"],
        }
    return out


def bench_serving_lifecycle(n_requests: int = 6, max_new: int = 12,
                            policies: tuple = ("darp", "all_bank"),
                            prefill_chunk: int = 8,
                            max_rounds: int = 800, device=None) -> dict:
    """`EngineCore` under a mixed-prompt batch (3..32-token prompts): per-
    policy TTFT/TPOT percentiles, stall/eviction counts, and the
    prefill/decode forward-call split that chunked prefill buys.

    Raises RuntimeError if any policy's engine fails to drain within
    `max_rounds`: a timed-out run has truncated percentiles and is never
    reported."""
    from repro_torch.kvcache import PagedKVConfig
    from repro_torch.serving import EngineConfig, EngineCore

    params, cfg, dims = _serving_model(device)
    prompts = [[1 + i] + [2 + (5 * j + i) % 11
                          for j in range(2 + (13 * i) % 30)]
               for i in range(n_requests)]
    out = {"prompt_lens": [len(p) for p in prompts], "max_new": max_new,
           "prefill_chunk": prefill_chunk}
    for pol in policies:
        kv_cfg = PagedKVConfig(
            n_layers=cfg.n_layers, n_kv_heads=dims.n_kv,
            head_dim=cfg.attention.head_dim, page_size=4, n_pages=128,
            n_staging=16, n_groups=4, max_seqs=8)
        ecfg = EngineConfig(
            max_batch=4, policy=pol, refresh_interval=3.0,
            prefill_chunk=prefill_chunk,
            force_threshold=0.99 if pol == "all_bank" else 0.8)
        eng = EngineCore(params, cfg, dims, kv_cfg, ecfg)
        for i, p in enumerate(prompts):
            eng.submit(p, max_new, rid=i)
        t0 = time.perf_counter()
        eng.run_until_done(max_rounds=max_rounds)
        wall = time.perf_counter() - t0
        if eng.stats["timed_out"]:
            raise RuntimeError(
                f"bench_serving_lifecycle: policy {pol!r} did not drain "
                f"within {max_rounds} rounds ({len(eng.queue)} queued / "
                f"{len(eng.active)} active left); refusing to report "
                "truncated percentiles")
        out[pol] = {
            "wall_s": round(wall, 2),
            "tokens": eng.stats["tokens"],
            "tok_per_s": round(eng.stats["tokens"] / wall, 1),
            "timed_out": eng.stats["timed_out"],
            "evictions": eng.stats["evictions"],
            **eng.metrics_summary(),
        }
    return out


def bench_serving_cosim(n_requests: int = 200,
                        scenario: str = "serving_bursty",
                        policies: tuple = ("dsarp", "darp", "ref_pb",
                                           "all_bank"),
                        seed: int = 0, check_identical: bool = True,
                        device=None) -> dict:
    """The serving <-> DRAM co-sim sweep: replay one serving scenario's KV
    page traffic through `DramSim` under each refresh policy and report
    tick-space TTFT/TPOT percentiles, and whether the paper's
    interference ordering (`policies` listed best to worst) holds end to
    end. `CoSimTimeout` propagates if an engine cannot drain; the
    determinism pin is `bit_identical`. The engine's stub forwards need
    no model; its paged cache lives on `device` (None: the card)."""
    from repro_torch.serving.cosim import (CoSimConfig, bit_identical_replay,
                                           compare_policies)

    device = "cuda" if device is None else str(device)
    out = compare_policies(policies, scenario=scenario,
                           n_requests=n_requests, seed=seed, device=device)
    t99 = [out[p]["ttft_ticks"]["p99"] for p in policies]
    q99 = [out[p]["tpot_ticks"]["p99"] for p in policies]
    stall = [out[p]["dram_stall_ticks"] for p in policies]
    res = {
        "scenario": scenario, "n_requests": n_requests, "seed": seed,
        "policies": list(policies),
        "ttft_p99_ordered": all(a <= b for a, b in zip(t99, t99[1:])),
        "tpot_p99_ordered": all(a <= b for a, b in zip(q99, q99[1:])),
        "stall_ordered": all(a <= b for a, b in zip(stall, stall[1:])),
        **out,
    }
    if check_identical:
        res["bit_identical"] = bit_identical_replay(
            CoSimConfig(policy=policies[0], scenario=scenario,
                        n_requests=n_requests, seed=seed, device=device))
    return res


def bench_sarp_bytes(seq_len: int = 32768, page: int = 64, hkv: int = 8,
                     d: int = 128) -> dict:
    """Derived per-token HBM traffic for the decode KV read path."""
    n_pages = seq_len // page
    kv_elems = 2 * n_pages * page * hkv * d          # k+v
    fused = kv_elems * 1                             # int8 read once
    serial = kv_elems * (1 + 2 + 2)                  # read i8, write+read bf16
    bf16_unquant = kv_elems * 2                      # bf16 cache, no quant
    return {
        "fused_GB": fused / 1e9,
        "serial_GB": serial / 1e9,
        "bf16_unquantized_GB": bf16_unquant / 1e9,
        "serial_over_fused": serial / fused,
        "bf16_over_fused": bf16_unquant / fused,
    }


def bench_kernel_micro(device=None) -> dict:
    """Mean us a call over 20 calls after one warm-up, the device
    synchronized before the clock starts and after the last call: the
    plain versions under the reference's keys (`flash_ref_us`,
    `kv_quant_us`, `ssd_ref_us`), the kernels under `*_kernel_us`. Inputs
    are made from seed 0 with numpy, at the reference's shapes: flash
    [8, 512, 64] causal, kv_quant pages [64, 64, 8, 64], SSD x
    [2, 512, 8, 64] with chunk 128; all float32, TF32 off."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_kernel_micro was asked to run on the card "
                           "but torch.cuda.is_available() is False")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timeit(fn, *args, n=20):
        fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        sync()
        return round((time.perf_counter() - t0) / n * 1e6, 1)

    rs = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        q = t(rs.randn(8, 512, 64))
        out["flash_ref_us"] = timeit(ref.flash_attention, q, q, q)
        out["flash_kernel_us"] = timeit(ops.flash_attention, q, q, q)

        pages = t(rs.randn(64, 64, 8, 64))
        out["kv_quant_us"] = timeit(ref.kv_quant, pages)
        out["kv_quant_kernel_us"] = timeit(ops.kv_quant, pages)

        x = t(rs.randn(2, 512, 8, 64))
        dt = t(np.abs(rs.randn(2, 512, 8)) * 0.1 + 0.01)
        A = t(-np.abs(rs.randn(8)) - 0.1)
        Bi = t(rs.randn(2, 512, 64))
        out["ssd_ref_us"] = timeit(
            lambda *a: ref.mamba2_ssd(*a, chunk=128), x, dt, A, Bi, Bi)
        out["ssd_kernel_us"] = timeit(
            lambda *a: ops.mamba2_ssd(*a, chunk=128), x, dt, A, Bi, Bi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out
