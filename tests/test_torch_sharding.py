"""`repro_torch.parallel.sharding`, `launch.mesh` and `launch.specs`'s
`to_shardings` against the reference's `repro.parallel.sharding` and
`repro.launch.specs`, in one process (no process group; the multi-process
checks are in `test_torch_distributed.py`).

  * the rule tables are the reference's;
  * `logical_to_spec` gives the reference's `PartitionSpec` entries for
    every logical axis, every pair of axes and every `disabled` set of
    one axis, under both rule tables;
  * `spec_to_placements` on the (2, 4) and (2, 16, 16) name shapes,
    and its refusals;
  * `shd` is the identity with no context and raises on a plain tensor
    with one; `axis_size` multiplies the named mesh axes;
  * `to_shardings`: the reference's own `to_shardings` run here on a
    one-device JAX mesh with the production meshes' axis names (a spec
    does not depend on the axes' sizes), for every arch x {train,
    prefill, decode} spec tree of `state_shapes_and_specs` at tp=16
    and both rule tables: the same tree, entry for entry the same spec,
    and the port's placements those of its spec;
  * `make_dims` at tp 1, 2, 4, 16 equals the reference's field for
    field (`kv_sharded` and the padded q heads drive the kv placements);
  * the mesh functions raise without a process group.

Tolerance: none (names, placements and integers).
"""
import itertools

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.common.config import get_arch as ref_get_arch
from repro.launch import specs as RSP
from repro.models.dims import make_dims as ref_make_dims
from repro.parallel import sharding as RS

from repro_torch.common.config import SHAPE_SETS, get_arch, list_archs
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.models.dims import make_dims
from repro_torch.parallel import sharding as S

RULES = {"single": (S.LOGICAL_RULES_SINGLE_POD, RS.LOGICAL_RULES_SINGLE_POD,
                    ("data", "model")),
         "multi": (S.LOGICAL_RULES_MULTI_POD, RS.LOGICAL_RULES_MULTI_POD,
                   ("pod", "data", "model"))}
AXES = sorted(S.LOGICAL_RULES_SINGLE_POD) + [None]
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


class _Mesh:
    """The parts of a `DeviceMesh` that the rule functions read."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, dim):
        return self.shape[dim]


@pytest.fixture
def ctx():
    """Sets both packages' contexts; clears them after."""
    def set_(rules_key, disabled=None, mesh=None):
        port, ref, _ = RULES[rules_key]
        S.set_sharding_context(mesh, port, disabled)
        RS.set_sharding_context(None, ref, disabled)
    yield set_
    S.set_sharding_context(None, None)
    RS.set_sharding_context(None, None)


def test_rule_tables_are_the_reference_s():
    assert S.LOGICAL_RULES_SINGLE_POD == RS.LOGICAL_RULES_SINGLE_POD
    assert S.LOGICAL_RULES_MULTI_POD == RS.LOGICAL_RULES_MULTI_POD


@pytest.mark.parametrize("rules", sorted(RULES))
def test_logical_to_spec_equals_reference(ctx, rules):
    cases = ([(a,) for a in AXES] + list(itertools.product(AXES, AXES))
             + [tuple(AXES)])
    for disabled in [None] + [{a} for a in AXES if a]:
        ctx(rules, disabled)
        for axes in cases:
            assert S.logical_to_spec(axes) == tuple(
                RS.logical_to_spec(axes)), (rules, disabled, axes)


def test_logical_to_spec_with_no_context_is_all_none():
    assert S.logical_to_spec(("batch", "heads", None)) == (None,) * 3


def test_spec_to_placements_on_the_host_and_production_meshes():
    f = S.spec_to_placements
    names = ("data", "model")                          # (2, 4)
    assert f(names, ("data", None, "model")) == (Shard(0), Shard(2))
    assert f(names, (None, None)) == (Replicate(), Replicate())
    assert f(names, ("model", "data")) == (Shard(1), Shard(0))
    assert f(names, ()) == (Replicate(), Replicate())
    names = ("pod", "data", "model")                   # (2, 16, 16)
    assert f(names, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert f(names, (None, "model")) == (Replicate(), Replicate(), Shard(1))
    assert f(names, (("pod", "data", "model"),)) == (Shard(0),) * 3
    with pytest.raises(ValueError, match="order"):
        f(names, (("data", "pod"),))
    with pytest.raises(ValueError, match="two"):
        f(names, ("data", "data"))


def test_axis_size_multiplies_the_named_mesh_axes(ctx):
    assert S.axis_size("batch") == 1                   # no context
    ctx("single", mesh=_Mesh((2, 4), ("data", "model")))
    assert [S.axis_size(a) for a in ("batch", "heads", "embed")] == [2, 4, 1]
    ctx("single", {"heads"}, mesh=_Mesh((2, 4), ("data", "model")))
    assert S.axis_size("heads") == 1
    ctx("multi", mesh=_Mesh((2, 16, 16), ("pod", "data", "model")))
    assert [S.axis_size(a) for a in ("batch", "fsdp", "ff")] == [32, 16, 16]


def test_shd_is_the_identity_with_no_context():
    x = torch.ones(2, 3)
    assert S.shd(x, "batch", None) is x
    assert S.place(x, "batch", None) is x
    assert S.named_sharding("batch") is None


def test_shd_raises_on_a_plain_tensor_under_a_context(ctx):
    ctx("single", mesh=_Mesh((2, 2), ("data", "model")))
    with pytest.raises(TypeError, match="plain tensor"):
        S.shd(torch.ones(2, 3), "batch", None)
    with pytest.raises(AssertionError, match="rank mismatch"):
        S.shd(torch.ones(2, 3), "batch")


def test_mesh_functions_raise_without_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        M.make_host_mesh(1, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        M.make_production_mesh(device="cpu")


def _compare_trees(got, want, names, where):
    if want is None:
        assert got is None, where
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _compare_trees(got[k], want[k], names, where + (k,))
        return
    assert isinstance(got, S.NamedSharding), where
    assert got.spec == tuple(want.spec), (where, got.spec, want.spec)
    assert got.placements == S.spec_to_placements(names, got.spec), where


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", list_archs())
def test_to_shardings_equals_reference(ctx, arch, rules):
    port, ref, names = RULES[rules]
    rmesh = jax.make_mesh((1,) * len(names), names)
    pmesh = _Mesh((1,) * len(names), names)
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    dims, rdims = make_dims(cfg, tp=16), ref_make_dims(rcfg, tp=16)
    ctx(rules)
    for kind, shape_name in KINDS.items():
        shape = SHAPE_SETS[shape_name]
        _, specs = SP.state_shapes_and_specs(cfg, dims, kind, shape)
        _, rspecs = RSP.state_shapes_and_specs(rcfg, rdims, kind, shape)
        with RS.sharding_context(rmesh, ref, set()):
            want = RSP.to_shardings(rmesh, rspecs)
        _compare_trees(SP.to_shardings(pmesh, specs), want, names,
                       (arch, kind))


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_make_dims_equals_reference(tp):
    for arch in list_archs():
        d, r = make_dims(get_arch(arch), tp=tp), ref_make_dims(
            ref_get_arch(arch), tp=tp)
        for f in ("tp", "n_q", "n_kv", "kv_sharded", "vocab", "ssm_heads",
                  "d_inner"):
            assert getattr(d, f) == getattr(r, f), (arch, tp, f)


def test_remat_recomputes_under_the_forward_context_in_another_thread():
    """On the card autograd runs the backward, and so a rematerialized
    layer's recompute, in a thread of its own, which does not see the
    thread-local context: `transformer.remat` installs the forward's."""
    import threading

    from repro_torch.models.transformer import remat
    mesh = _Mesh((1, 1), ("data", "model"))
    seen = []

    def layer(x):
        seen.append(S.current_mesh())
        return x * x

    x = torch.ones(3, requires_grad=True)
    with S.sharding_context(mesh, S.LOGICAL_RULES_SINGLE_POD):
        total = remat(layer, "train", x).sum()
    worker = threading.Thread(target=total.backward)
    worker.start()
    worker.join()
    assert seen == [mesh, mesh]                  # forward, recompute
    assert torch.equal(x.grad, 2 * torch.ones(3))


def test_implicit_replication_is_reentrant():
    from torch.distributed.tensor import DTensor
    flag = lambda: DTensor._op_dispatcher._allow_implicit_replication  # noqa
    with S.implicit_replication():
        with S.implicit_replication():
            assert flag()
        assert flag()
    assert not flag()
