"""The port's multi-card slice on the CPU: 4 gloo processes a test
(`_torch_dist_workers.run_ranks`, each spawn with its own 180 s limit),
on host meshes (data=2, model=2) and (data=1, model=4).

  * (a) Dense: qwen2.5-3b `.reduced()`, batch 4 x 32 (the reference's
    own `test_sharded_step_matches_single_device` case), from the
    reference's `make_state(PRNGKey(0))` carried across with
    `state_from_numpy`. The sharded step equals the port's one-process
    step at `REL` = 1e-5 of each leaf's largest magnitude (loss, every
    gradient leaf, m, v), params after the step within `_param_bar`
    (the difference a gradient's bar can make through AdamW's first
    step, `test_torch_train_step.py`); the loss is replicated and every
    gradient carries its param's placements. Also with a factored
    second moment (`OptConfig(factored_v=True)`), whose means reduce over
    sharded dimensions. The one-process step
    equals the reference's single-device JAX step at the reference
    test's bars (loss 2e-3, params 5e-3).
  * (b) MoE: qwen3-moe `.reduced()` (4 experts, top 2). Capacity and
    the aux loss are per data shard, as the reference's `shard_map` body
    computes them (aux averaged over the shards). On (1, 4), one data
    shard, the step holds at the bars of (a) as the config stands. On
    (2, 2) the step runs with the capacity factor raised to n_experts /
    top_k (an expert's capacity holds every token of a shard, so no
    token is dropped on one device or on a shard: `dropped` == 0 on
    both) and the aux weight at 0, and holds at the bars of (a); the
    block itself is held to the per-shard semantics on both meshes at a
    capacity factor of 0.5, where tokens are dropped: `_moe_local_body`
    run here on each data shard's tokens, aux and drops averaged.
  * (c) Every family's `train_loss`, `prefill` and one `decode_step`
    under the mesh equal the same calls with no context at `REL`: this
    passes every restored `shd` site, kernel E's and F's `local_map`
    routes (their plain versions on the CPU) and the MoE mesh branch.
  * (d) The reference's `test_elastic_restore_across_device_counts` on
    the port: a checkpoint saved by one process (the port's, and one the
    reference's engine wrote) restores sharded on 4 ranks with
    `shardings=to_shardings(...)`; each rank's local shard equals its
    slice of the saved leaf and every full tensor equals the saved leaf
    exactly; the sharded state saved back writes the same bytes.
  * The multi-pod rule's batch axis ("pod", "data") splits rows in JAX's
    row-major order over the named axes; the production meshes refuse a
    world of 4 by name.
  * The dry run's count against a real run: `analyze_ops` of the reduced
    qwen2-0.5b's train step (f32, 4 x 32) on a (2, 2) "cpu" mesh, in a
    fake 4-rank world on `meta` (`launch.mesh.fake_world`, one process)
    and on 4 gloo processes over real tensors: rank 0's collectives by
    kind, their wire bytes and links, its ops and FLOPs, all equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_workers as W

REL = 1e-5
MESHES = [2, 4]                     # model ways; data = 4 // model
FAMILIES = ["qwen2.5-3b", "qwen3-moe-235b-a22b", "mamba2-130m",
            "zamba2-7b", "seamless-m4t-large-v2"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _param_bar(m_ref, p_ref, lr):
    """`test_torch_train_step._param_bar`: the bar on a param after a
    first AdamW step whose gradient (m / (1 - b1)) is held at `REL`."""
    x = np.abs(np.asarray(m_ref, np.float32)) / 0.1
    d = REL * float(x.max())
    move = np.minimum(2.0, d * 1e-8 / (np.maximum(x - d, 0.0) + 1e-8) ** 2)
    return lr * move + REL * float(np.abs(np.asarray(p_ref)).max())


def _hold(got, want, rel, what):
    err, bar = W.np_close(got, want, rel)
    assert np.isfinite(np.asarray(got)).all(), what
    assert err <= bar, f"{what}: max abs difference {err} over {bar}"


def _hold_step(out, lr):
    """The sharded step against the one-process step (`step_worker`)."""
    _hold(out["loss4"], out["loss1"], REL, "grad_fn loss")
    _hold(out["step_loss4"], out["step_loss1"], REL, "step loss")
    assert out["loss_placements"] == ["R", "R"]
    assert out["g1"].keys() == out["g4"].keys()
    for path in out["g1"]:
        _hold(out["g4"][path], out["g1"][path], REL, f"gradient {path}")
        assert out["g_placements"][path] == out["p_placements"][path], path
    for path, want in out["new1"].items():
        got = out["new4"][path]
        if path.startswith("params/"):
            m = out["new1"]["opt/m/" + path[len("params/"):]]
            err = np.abs(got - want)
            bar = _param_bar(m, want, lr)
            assert (err <= bar).all(), (path, float((err - bar).max()))
        else:
            _hold(got, want, REL, path)


# ------------------------------------------------------------------ (a)

@pytest.fixture(scope="module")
def dense_reference():
    """The reference's single-device state and step for qwen2.5-3b
    `.reduced()` on its own batch (`test_distributed.py`'s case)."""
    from repro.common.config import get_arch
    from repro.data import SyntheticLMData
    from repro.models.dims import make_dims
    from repro.optim import OptConfig
    from repro.train import make_state, make_train_step
    cfg = get_arch("qwen2.5-3b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=jnp.float32,
                     compute_dtype=jnp.float32)
    ocfg = OptConfig(**OPT)
    data = SyntheticLMData(cfg.vocab_size, batch=4, seq=32, seed=0)
    batch = {k: jnp.asarray(v) for k, v in data.batch_at(0).items()}
    state = make_state(jax.random.PRNGKey(0), cfg, dims, ocfg)
    new, metrics = jax.jit(make_train_step(cfg, dims, ocfg))(state, batch)
    return (jax.device_get(state), float(metrics["loss"]),
            [np.asarray(x) for x in
             jax.tree_util.tree_leaves(jax.device_get(new["params"]))])


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"model{m}")
def dense_step(request, dense_reference):
    state_np = dense_reference[0]
    (out,) = W.run_ranks(W.step_worker, arch="qwen2.5-3b",
                         model=request.param, state_np=state_np,
                         lr=OPT["lr"])[:1]
    return out


def test_dense_sharded_step_equals_one_process_step(dense_step):
    _hold_step(dense_step, OPT["lr"])


def test_dense_one_process_step_equals_reference(dense_step,
                                                 dense_reference):
    _, ref_loss, ref_params = dense_reference
    assert abs(dense_step["step_loss1"] - ref_loss) < 2e-3
    params = [v for k, v in dense_step["new1"].items()
              if k.startswith("params/")]
    assert len(params) == len(ref_params)
    for got, want in zip(params, ref_params):
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


def test_dense_sharded_step_equals_reference(dense_step, dense_reference):
    """The reference test's own assertion, on the port's sharded step."""
    _, ref_loss, ref_params = dense_reference
    assert abs(dense_step["step_loss4"] - ref_loss) < 2e-3
    params = [v for k, v in dense_step["new4"].items()
              if k.startswith("params/")]
    for got, want in zip(params, ref_params):
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("model", MESHES, ids=lambda m: f"model{m}")
def test_dense_sharded_step_with_a_factored_second_moment(model):
    """The factored v's row and col means reduce over sharded dimensions:
    their `Partial` values are resolved to the moments' cut placements."""
    (out,) = W.run_ranks(W.step_worker, arch="qwen2.5-3b", model=model,
                         lr=OPT["lr"], opt=dict(factored_v=True))[:1]
    assert any(k.endswith("/row") for k in out["new4"])
    _hold_step(out, OPT["lr"])


# ------------------------------------------------------------------ (b)

def test_moe_sharded_step_on_one_data_shard():
    """(1, 4): one data shard, so capacity and aux are one device's."""
    (out,) = W.run_ranks(W.step_worker, arch="qwen3-moe-235b-a22b",
                         model=4, lr=OPT["lr"])[:1]
    assert out["drops"][0] == out["drops"][1]
    _hold_step(out, OPT["lr"])


def test_moe_sharded_step_on_two_data_shards_with_no_token_dropped():
    """(2, 2): the capacity factor raised to n_experts / top_k, so that
    no token is dropped on one device or on a shard, and the aux loss's
    weight 0: aux is the mean of the data shards' aux, each over its own
    tokens (the reference's pmean), which is not one device's aux over
    all of them. `test_moe_block_holds_per_shard_capacity` holds the
    block's aux and drops to those per-shard semantics."""
    m = W._cfg("qwen3-moe-235b-a22b").moe
    (out,) = W.run_ranks(W.step_worker, arch="qwen3-moe-235b-a22b",
                         model=2, lr=OPT["lr"],
                         moe=dict(capacity_factor=m.n_experts / m.top_k,
                                  router_aux_weight=0.0))[:1]
    assert out["drops"] == (0.0, 0.0)
    _hold_step(out, OPT["lr"])


@pytest.mark.parametrize("model", MESHES, ids=lambda m: f"model{m}")
def test_moe_block_holds_per_shard_capacity(model):
    (out,) = W.run_ranks(W.moe_shard_worker, model=model)[:1]
    for what, got, want in zip(("h", "aux", "dropped"), out["got"],
                               out["want"]):
        _hold(got, want, REL, what)
    assert float(out["want"][2]) > 0.0              # capacity binds


# ------------------------------------------------------------------ (c)

@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"model{m}")
def family_runs(request):
    (out,) = W.run_ranks(W.families_worker, archs=FAMILIES,
                         model=request.param)[:1]
    return out


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("part", ["loss", "logits", "state", "dlogits",
                                  "dstate"])
def test_family_under_mesh_equals_no_context(family_runs, arch, part):
    run = family_runs[arch]
    one, sharded = run["one"][part], run["sharded"][part]
    if isinstance(one, dict):
        assert one.keys() == sharded.keys()
        for k in one:
            _hold(sharded[k], one[k], REL, f"{part} {k}")
    else:
        _hold(sharded, one, REL, part)


# ------------------------------------------------------------------ (d)

def _save_port_checkpoint(d):
    """qwen2-0.5b `.reduced()` saved from this process by the port's
    engine at step 5 (the reference test's save)."""
    import torch

    from repro_torch.checkpoint import CheckpointConfig, CheckpointEngine
    from repro_torch.common.config import get_arch
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.train.step import make_state
    cfg = get_arch("qwen2-0.5b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    state = make_state(torch.Generator().manual_seed(7), cfg, dims,
                       OptConfig(), device="cpu")
    eng = CheckpointEngine(CheckpointConfig(directory=d, interval=1,
                                            n_banks=3))
    eng.force_snapshot(5, state)
    eng.flush_all_now()
    eng.wait()


def _save_reference_checkpoint(d):
    from repro.checkpoint import CheckpointConfig, CheckpointEngine
    from repro.common.config import get_arch
    from repro.models.dims import make_dims
    from repro.optim import OptConfig
    from repro.train import make_state
    cfg = get_arch("qwen2-0.5b").reduced()
    dims = make_dims(cfg, tp=1, param_dtype=jnp.float32,
                     compute_dtype=jnp.float32)
    state = make_state(jax.random.PRNGKey(7), cfg, dims, OptConfig())
    eng = CheckpointEngine(CheckpointConfig(directory=d, interval=1,
                                            n_banks=3))
    eng.force_snapshot(5, state)
    eng.flush_all_now()
    eng.wait()


def _saved_leaves(d):
    ep = os.path.join(d, "step_00000005")
    out = {}
    for b in range(3):
        with np.load(os.path.join(ep, f"bank_{b}.npz")) as z:
            out.update({int(k): z[k] for k in z.files})
    return [out[i] for i in range(len(out))]


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    base = tmp_path_factory.mktemp("elastic")
    dirs = [str(base / "port"), str(base / "reference")]
    _save_port_checkpoint(dirs[0])
    _save_reference_checkpoint(dirs[1])
    out = W.run_ranks(W.restore_worker, ckpt_dirs=dirs, model=4,
                      out_dir=str(base / "resaved"))
    return dirs, str(base / "resaved"), out


@pytest.mark.parametrize("which", [0, 1], ids=["port", "reference"])
def test_checkpoint_restores_sharded_on_four_ranks(restored, which):
    dirs, _, ranks = restored
    saved = _saved_leaves(dirs[which])
    sharded_leaves = 0
    for r in ranks:
        ck = r["ckpts"][which]
        assert ck["step"] == 5
        for path, local, pl, want in zip(ck["paths"], ck["local"],
                                         ck["placements"], saved):
            exp = W.expected_local(want, pl, r["coord"], r["mesh_shape"])
            assert local.shape == exp.shape, path
            assert np.array_equal(local, exp), path
            sharded_leaves += any(p.startswith("S") for p in pl)
    assert sharded_leaves > 0                  # actually resharded
    for path, got, want in zip(ranks[0]["ckpts"][which]["paths"],
                               ranks[0]["ckpts"][which]["full"], saved):
        assert np.array_equal(got, want), path


@pytest.mark.parametrize("which", [0, 1], ids=["port", "reference"])
def test_sharded_state_saves_the_unsharded_bytes(restored, which):
    dirs, resaved, _ = restored
    want = _saved_leaves(dirs[which])
    for rank in range(4):
        got = _saved_leaves(os.path.join(resaved, f"ckpt{which}_rank{rank}"))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------------------------ the meshes

def test_multi_pod_batch_rows_follow_row_major_order():
    ranks = W.run_ranks(W.order_worker)
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r in ranks:
        pod, data, _ = r["coord"]
        block = pod * 2 + data               # JAX: row-major over (pod, data)
        assert np.array_equal(r["rows"], full[2 * block:2 * block + 2])
        assert r["placements"] == ["S0", "S0", "R"]


def test_mesh_functions_refuse_a_world_they_do_not_fit():
    (out,) = W.run_ranks(W.mesh_errors_worker)[:1]
    assert "256" in out["single"] and "4" in out["single"]
    assert "512" in out["multi"] and "4" in out["multi"]
    assert "model=3" in out["host3"]
    assert out["host2"] == ([2, 2], ["data", "model"])



# ------------------------------------------------------ the dry run's count

@pytest.fixture(scope="module")
def step_counts():
    fake = W.run_alone(W.count_step_worker, model=2, fake=True)
    (real,) = W.run_ranks(W.count_step_worker, model=2)[:1]
    return fake, real


@pytest.mark.parametrize("field", ["counts", "wire", "wire_bytes", "links",
                                   "link_wire", "n_ops", "flops"])
def test_fake_world_counts_what_a_gloo_run_runs(step_counts, field):
    fake, real = step_counts
    assert (fake["backend"], real["backend"]) == ("fake", "gloo")
    assert fake["counts"].get("all-gather", 0) > 0
    assert fake["counts"].get("all-reduce", 0) > 0
    assert fake[field] == real[field]
