"""Per-device shapes of the dry run's production cells, each package in a
fresh interpreter of its own (`test_torch_dryrun_pods*.py`, through
`both_sides` and `hold_cell`):

    python tests/_torch_pod_shapes.py reference MESH ARCH:SHAPE ...
    python tests/_torch_pod_shapes.py port MESH ARCH:SHAPE ...

MESH is ``pod16x16`` or ``pod2x16x16``. Prints one JSON object: for each
cell, ``[[shape, itemsize], ...]`` a leaf, state leaves in JAX's flatten
order, then the step's other input (the batch, or the decode token). The
reference's side imports `repro.launch.dryrun`, which sets `XLA_FLAGS`
to 512 host devices before JAX starts, and takes each leaf's
`NamedSharding.shard_shape` over `to_shardings(make_production_mesh(),
specs)`, the sharding in the cell's rules; nothing is compiled. Where a
dimension does not divide, it takes XLA's padded shard, the ceiling
(`shard_shape` refuses such a dimension). The port's side lays each
cell out with `launch.dryrun.production_cell` (a fake world of the
mesh's size) and reads rank 0's local shapes, and the bytes
`op_analysis.tree_bytes` counts as the step's arguments
(``__argument_bytes__``).
"""
from __future__ import annotations

import json
import sys

MULTI = {"pod16x16": False, "pod2x16x16": True}


def _cells(argv):
    return [tuple(c.split(":")) for c in argv]


def reference(mesh_name, cells):
    import repro.launch.dryrun  # noqa: F401  (XLA_FLAGS before JAX starts)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.common.config import SHAPE_SETS, get_arch
    from repro.launch import specs as SP
    from repro.launch.mesh import make_production_mesh
    from repro.models.dims import make_dims
    from repro.parallel import (LOGICAL_RULES_MULTI_POD,
                                LOGICAL_RULES_SINGLE_POD, sharding_context)

    multi = MULTI[mesh_name]
    mesh = make_production_mesh(multi_pod=multi)
    rules = LOGICAL_RULES_MULTI_POD if multi else LOGICAL_RULES_SINGLE_POD

    def shard(sharding, shape):
        try:
            return list(sharding.shard_shape(tuple(shape)))
        except ValueError:      # a dimension its axes do not divide
            pass
        out = list(shape)
        for d, entry in enumerate(sharding.spec):
            if entry is None:
                continue
            n = 1
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                n *= mesh.shape[ax]
            out[d] = -(-shape[d] // n)
        return out

    def leaves(tree, axes):
        shards = SP.to_shardings(mesh, axes)
        flat = jax.tree.leaves(tree)
        flat_sh = jax.tree.leaves(
            shards, is_leaf=lambda x: x is None or hasattr(x, "spec"))
        assert len(flat) == len(flat_sh)
        return [[shard(s, x.shape), int(np.dtype(x.dtype).itemsize)]
                for x, s in zip(flat, flat_sh)]

    out = {}
    for arch, shape_name in cells:
        cfg, shape = get_arch(arch), SHAPE_SETS[shape_name]
        disabled = ({"batch"} if shape.global_batch < mesh.shape["data"]
                    else set())
        dims = make_dims(cfg, tp=mesh.shape["model"])
        # shapes outside the context: the models' `shd` constraints refuse
        # this JAX's explicit mesh axes, and shapes do not depend on them
        state, specs = SP.state_shapes_and_specs(cfg, dims, shape.kind,
                                                 shape)
        if shape.kind == "decode":
            b = shape.global_batch
            if cfg.frontend == "embed" and cfg.family != "encdec":
                other = {"embed": SP.sds((b, cfg.d_model), jnp.bfloat16)}
                axes = {"embed": ("batch", None)}
            else:
                other = {"token": SP.sds((b,), jnp.int32)}
                axes = {"token": ("batch",)}
        else:
            other = SP.batch_specs(cfg, shape,
                                   with_labels=shape.kind == "train")
            axes = SP.batch_spec_axes(cfg, other)
        with sharding_context(mesh, rules, disabled):
            got = leaves(state, specs) + leaves(other, axes)
        out[f"{arch}:{shape_name}"] = got
    return out


def port(mesh_name, cells):
    from repro_torch.common.config import SHAPE_SETS, get_arch
    from repro_torch.common.treeutil import tree_leaves
    from repro_torch.launch.dryrun import production_cell
    from repro_torch.parallel.op_analysis import tree_bytes
    out = {}
    for arch, shape_name in cells:
        key = f"{arch}:{shape_name}"
        with production_cell(get_arch(arch), SHAPE_SETS[shape_name],
                             MULTI[mesh_name]) as (_, args, _, _):
            out[key] = [[list(x.to_local().shape), x.element_size()]
                        for a in args for x in tree_leaves(a)]
            out[f"{key}:__argument_bytes__"] = tree_bytes(args)
    return out


def both_sides(mesh_name, cells) -> tuple:
    """(the reference's shapes, the port's) of `cells` on `mesh_name`,
    this script run once a side, both at once, each in an interpreter of
    its own."""
    import os
    import subprocess
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, side, mesh_name]
        + [f"{a}:{s}" for a, s in cells], cwd=str(root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(root / "src"),
                 JAX_PLATFORMS="cpu"))
        for side in ("reference", "port")]
    out = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr[-3000:]
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return tuple(out)


def hold_cell(mesh_name, ref, port, arch, shape_name):
    """The port's rank-0 shards of one cell equal the reference's, leaf
    for leaf; its argument bytes, and the committed record's
    `argument_gb`, equal their total."""
    import math
    from pathlib import Path
    key = f"{arch}:{shape_name}"
    assert len(port[key]) == len(ref[key])
    for i, (got, want) in enumerate(zip(port[key], ref[key])):
        assert got == want, (key, i)
    total = sum(math.prod(s) * b for s, b in ref[key])
    assert port[f"{key}:__argument_bytes__"] == total
    path = (Path(__file__).resolve().parents[1] / "results" / "dryrun_torch"
            / f"{arch}__{shape_name}__{mesh_name}.json")
    rec = json.loads(path.read_text())
    assert rec["ok"] and rec["memory"]["argument_gb"] == total / 1e9


if __name__ == "__main__":
    side, mesh_name = sys.argv[1], sys.argv[2]
    fn = {"reference": reference, "port": port}[side]
    print(json.dumps(fn(mesh_name, _cells(sys.argv[3:]))))
