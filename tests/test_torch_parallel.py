"""The port's mesh plans and sharding rules against the JAX package's.

- `plan_mesh` equals the reference's exactly over a grid of chip counts
  (1–64), model scales, sequence lengths, expert counts, tp caps and host
  sizes, with and without a pool topology; `remesh_plan` equals the plan of
  the reference's `remesh` (on its 8 CPU devices, conftest.py).
- The rules are the reference's, pattern for pattern; `_fit_spec` and
  `batch_sharding` give its specs on the same mesh shapes.
- For every parameter of llama_tiny, llama_tiny scanned and resnet_tiny,
  the reference leaf the port names (shape included) and the rules' spec
  fitted to it equal the reference's `param_shardings` on a mesh of the
  same shape, and the torch dimension each axis splits is the one that
  holds the reference's dimension (tp split nowhere on UNSPLIT_OVER_TP).
- The refusals: sp and pp plans (an MoE bundle's too, whose dp, fsdp, ep
  and tp plans run), and a batch the data axes do not divide, before any
  process group forms; a session of several chips without one.
- make_flash_attention refuses a DTensor and runs on local tensors.
"""

import dataclasses
import itertools
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from vodascheduler_tpu.models import llama as jllama
from vodascheduler_tpu.models import resnet as jresnet
from vodascheduler_tpu.parallel import mesh as jmesh
from vodascheduler_tpu.parallel import sharding as jsharding
from vodascheduler_tpu.placement.topology import PoolTopology as JPool
from vodascheduler_tpu_torch.models import llama as tllama
from vodascheduler_tpu_torch.models import resnet as tresnet
from vodascheduler_tpu_torch.models.registry import get_model, llama_bundle
from vodascheduler_tpu_torch.ops.flash_attention import make_flash_attention
from vodascheduler_tpu_torch.parallel import mesh as tmesh
from vodascheduler_tpu_torch.parallel import sharding as tsharding
from vodascheduler_tpu_torch.placement.topology import PoolTopology as TPool
from vodascheduler_tpu_torch.runtime.train import TrainSession, plan_for

TOPOLOGIES = [None, "4x4/2x2", "8/1", "16/8", "4x4x4/2x2x1"]


def _plan(p) -> dict:
    return {a: getattr(p, a) for a in tmesh.AXES}


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_plan_mesh_equals_the_reference(topology):
    jtopo = JPool.parse(topology) if topology else None
    ttopo = TPool.parse(topology) if topology else None
    grid = itertools.product(range(1, 65), (0.0, 0.35, 1.0, 8.0, 47.0),
                             (0, 2048, 32768, 131072), (0, 4, 8),
                             (1, 2, 4, 8), (1, 4, 8))
    n = 0
    for chips, pb, seq, experts, max_tp, cph in grid:
        kw = dict(model_params_b=pb, seq_len=seq, num_experts=experts,
                  max_tp=max_tp, chips_per_host=cph)
        want = jmesh.plan_mesh(chips, topology=jtopo, **kw)
        got = tmesh.plan_mesh(chips, topology=ttopo, **kw)
        assert _plan(got) == _plan(want), (chips, kw)
        assert got.num_chips == want.num_chips
        assert got.active_axes() == want.active_axes()
        n += 1
    assert n == 64 * 5 * 4 * 3 * 4 * 3
    assert tmesh.AXES == jmesh.AXES
    # the mesh's axes: the reference's order, less those the port does
    # not run
    order = ("dp", "pp", "fsdp", "sp", "ep", "tp")
    assert tmesh.MESH_AXES == tuple(a for a in order
                                    if a not in ("pp", "sp"))


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_remesh_plans_as_the_reference(topology):
    jtopo = JPool.parse(topology) if topology else None
    ttopo = TPool.parse(topology) if topology else None
    for chips, pb, seq, experts in itertools.product(
            range(1, 9), (0.0, 1.0, 8.0), (0, 65536), (0, 8)):
        kw = dict(model_params_b=pb, seq_len=seq, num_experts=experts)
        want, _ = jmesh.remesh(chips, devices=jax.devices(), topology=jtopo,
                               **kw)
        got = tmesh.remesh_plan(chips, topology=ttopo, **kw)
        assert _plan(got) == _plan(want), (chips, kw, topology)
    pinned = tmesh.MeshPlan(fsdp=2, tp=2)
    assert tmesh.remesh_plan(4, model_params_b=8.0, plan=pinned) is pinned


def _spec(p) -> tuple:
    return tuple(p)


def test_rules_are_the_references():
    for ours, ref in ((tsharding.TRANSFORMER_RULES,
                       jsharding.TRANSFORMER_RULES),
                      (tsharding.CONV_RULES, jsharding.CONV_RULES)):
        assert [(pat, spec) for pat, spec in ours.rules] == [
            (pat, _spec(spec)) for pat, spec in ref.rules]
        assert ours.default == _spec(ref.default)
    for path in ("layers_scan/block/attn/q_proj/kernel",
                 "layer_3/mlp/down_proj/kernel", "embed/embedding",
                 "layer_0/moe/experts_up_kernel", "final_norm/scale",
                 "conv_init/kernel", "head/kernel", "nowhere"):
        for ours, ref in ((tsharding.TRANSFORMER_RULES,
                           jsharding.TRANSFORMER_RULES),
                          (tsharding.CONV_RULES, jsharding.CONV_RULES)):
            assert ours.spec_for(path) == _spec(ref.spec_for(path)), path


MESH_SHAPES = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (1, 2, 2),
               (2, 2, 2), (1, 4, 1), (1, 1, 4), (2, 1, 4), (1, 8, 1),
               (1, 1, 8)]


def _jax_mesh(dp, fsdp, tp):
    plan = jmesh.MeshPlan(dp=dp, fsdp=fsdp, tp=tp)
    return jmesh.build_mesh(plan, jax.devices()[:plan.num_chips])


def _padded(spec, rank):
    spec = tuple(spec)
    return spec + (None,) * (rank - len(spec))


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_fit_spec_and_batch_sharding_equal_the_references(shape):
    mesh = _jax_mesh(*shape)
    mesh_shape = dict(zip(("dp", "fsdp", "tp"), shape))
    specs = [jsharding.P("fsdp", "tp"), jsharding.P("tp", "fsdp"),
             jsharding.P("pp", "fsdp", "tp"), jsharding.P(),
             jsharding.P(None, None, None, "fsdp"),
             jsharding.P("ep", "tp", "fsdp")]
    shapes = [(64,), (64, 256), (3, 64, 4, 16), (4, 4, 4, 8), (6, 10),
              (2, 3, 5, 7), (8, 2, 2)]
    for spec, arr in itertools.product(specs, shapes):
        want = jsharding._fit_spec(spec, arr, mesh)
        got = tsharding._fit_spec(_spec(spec), arr, mesh_shape)
        assert got == _padded(want, len(arr)), (spec, arr)
    for seq_axis in (None, "sp"):
        assert tsharding.batch_sharding(mesh_shape, seq_axis) == _spec(
            jsharding.batch_sharding(mesh, seq_axis).spec)


def _jax_params(name):
    if name == "resnet_tiny":
        module = jresnet.ResNet(jresnet.RESNET_TINY)
        x = jax.numpy.zeros((1, 32, 32, 3))
    else:
        cfg = jllama.LLAMA_TINY_SCAN if name == "llama_tiny_scan" \
            else jllama.LLAMA_TINY
        module = jllama.Llama(cfg)
        x = jax.numpy.zeros((1, 8), jax.numpy.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return shapes["params"]


def _torch_module(name):
    if name == "resnet_tiny":
        return tresnet.ResNet(tresnet.RESNET_TINY, device="cpu")
    cfg = tllama.LLAMA_TINY_SCAN if name == "llama_tiny_scan" \
        else tllama.LLAMA_TINY
    return tllama.Llama(cfg, device="cpu")


RULES = {"resnet_tiny": "CONV_RULES", "llama_tiny": "TRANSFORMER_RULES",
         "llama_tiny_scan": "TRANSFORMER_RULES"}


@pytest.mark.parametrize("name", sorted(RULES))
def test_placements_equal_the_references(name):
    jparams = _jax_params(name)
    module = _torch_module(name)
    leaves = tsharding.reference_leaves(module)
    ref_shapes = {jsharding._path_str(path): tuple(leaf.shape)
                  for path, leaf in
                  jax.tree_util.tree_flatten_with_path(jparams)[0]}
    # every parameter of the port is (a slice of) a leaf of the reference,
    # of the reference's shape, and every leaf is covered
    assert {leaf.path for leaf in leaves.values()} == set(ref_shapes)
    for pname, leaf in leaves.items():
        assert leaf.shape == ref_shapes[leaf.path], pname
    ours, ref = getattr(tsharding, RULES[name]), getattr(jsharding,
                                                         RULES[name])
    unsplit = 0
    for shape in MESH_SHAPES:
        mesh = _jax_mesh(*shape)
        mesh_shape = dict(zip(("dp", "fsdp", "tp"), shape))
        want = {jsharding._path_str(path): tuple(s.spec) for path, s in
                jax.tree_util.tree_flatten_with_path(
                    jsharding.param_shardings(jparams, mesh, ref))[0]}
        placements = tsharding.param_placements(module, ours, mesh_shape)
        for pname, entry in placements.items():
            leaf = entry["leaf"]
            assert entry["spec"] == _padded(want[leaf.path],
                                            len(leaf.shape)), (pname, shape)
            for i, axis in enumerate(entry["spec"]):
                if axis is None or leaf.torch_dims[i] is None:
                    continue
                if axis == "tp" and any(re.search(p, leaf.path)
                                        for p in tsharding.UNSPLIT_OVER_TP):
                    assert "tp" not in entry["split"]
                    unsplit += 1
                    continue
                assert entry["split"][axis] == leaf.torch_dims[i], pname
    if name != "resnet_tiny":
        assert unsplit > 0  # the named divergence is exercised


def test_llama_tp_splits_heads_as_the_reference():
    """At tp=4, llama_tiny's 4 heads split and its 2 kv heads do not: the
    reference's _fit_spec on [D, H, hd] keeps k/v whole, and so does the
    port (each rank takes its heads of the expanded k/v)."""
    module = _torch_module("llama_tiny")
    placements = tsharding.param_placements(
        module, tsharding.TRANSFORMER_RULES, {"tp": 4})
    split = {k: v["split"] for k, v in placements.items()
             if k.startswith("layers.0.attn.")}
    assert split == {"layers.0.attn.q_proj.weight": {"tp": 0},
                     "layers.0.attn.k_proj.weight": {},
                     "layers.0.attn.v_proj.weight": {},
                     "layers.0.attn.o_proj.weight": {"tp": 1}}


def _bundle(name="llama_tiny"):
    return get_model(name)


@pytest.mark.parametrize("plan, match", [
    (tmesh.MeshPlan(sp=2), "A13"),
    (tmesh.MeshPlan(pp=2), "A13"),
    (tmesh.MeshPlan(ep=2, sp=2), "A13"),
])
def test_plans_the_port_does_not_run_are_refused(plan, match):
    with pytest.raises(NotImplementedError, match=match):
        plan_for(_bundle(), plan.num_chips, 8, plan=plan)
    with pytest.raises(NotImplementedError, match=match):
        tmesh.check_runnable(plan)


@pytest.mark.parametrize("plan", [tmesh.MeshPlan(dp=2),
                                  tmesh.MeshPlan(fsdp=2),
                                  tmesh.MeshPlan(tp=2)])
def test_an_moe_bundle_on_several_ranks_is_refused(plan):
    """Since the ep axis, an MoE bundle runs over dp, fsdp, ep and tp; it
    is refused on several ranks only where an axis is one the port does
    not run (sp, pp: A13), as every bundle is."""
    moe = _bundle("mixtral_tiny")
    assert plan_for(moe, 2, 8, plan=plan) == plan
    assert plan_for(moe, 2, 8) == tmesh.MeshPlan(ep=2)
    assert plan_for(moe, 1, 8) == tmesh.MeshPlan()
    for axis in ("sp", "pp"):
        refused = dataclasses.replace(plan, **{axis: 2})
        with pytest.raises(NotImplementedError, match="A13"):
            plan_for(moe, refused.num_chips, 8, plan=refused)


def test_batches_and_sessions_the_mesh_cannot_take_are_refused():
    with pytest.raises(ValueError, match="does not divide"):
        plan_for(_bundle(), 4, 6, plan=tmesh.MeshPlan(dp=2, fsdp=2))
    assert plan_for(_bundle(), 4, 6, plan=tmesh.MeshPlan(dp=2, tp=2)) == \
        tmesh.MeshPlan(dp=2, tp=2)
    with pytest.raises(ValueError, match="covers"):
        plan_for(_bundle(), 4, 8, plan=tmesh.MeshPlan(dp=2))
    # several chips need a process group of as many ranks
    with pytest.raises(ValueError, match="process group"):
        TrainSession(_bundle(), 2, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        TrainSession(_bundle(), 1, device="cpu",
                     plan=tmesh.MeshPlan(fsdp=2))


def test_registry_carries_the_references_scale_and_rules():
    from vodascheduler_tpu.models import registry as jreg
    from vodascheduler_tpu_torch.models import registry as treg
    for name in treg.MODEL_REGISTRY:
        got, want = treg.get_model(name), jreg.get_model(name)
        assert got.params_b == want.params_b, name
        assert [(p, s) for p, s in got.rules.rules] == [
            (p, _spec(s)) for p, s in want.rules.rules], name


def test_local_rows_cut_the_global_batch():
    batch = {"inputs": torch.arange(16).reshape(8, 2),
             "nested": [torch.arange(8)]}
    parts = [tsharding.local_rows(batch, 4, r) for r in range(4)]
    assert torch.equal(torch.cat([p["inputs"] for p in parts]),
                       batch["inputs"])
    assert torch.equal(parts[2]["nested"][0], torch.tensor([4, 5]))
    assert tsharding.local_rows(batch, 1, 0) is batch
    with pytest.raises(ValueError, match="does not divide"):
        tsharding.local_rows(batch, 3, 0)


def test_flash_attention_takes_local_tensors_and_refuses_dtensors(
        tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    attn = make_flash_attention(None, causal=True)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 2, 16, generator=g) for _ in range(3))
    from vodascheduler_tpu_torch.parallel.ring_attention import (
        reference_attention,
    )
    np.testing.assert_allclose(attn(q, k, v).numpy(),
                               reference_attention(q, k, v).numpy(),
                               atol=1e-5)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        dq = distribute_tensor(q, mesh)
        with pytest.raises(TypeError, match="DTensor"):
            attn(dq, k, v)
    finally:
        dist.destroy_process_group()


def test_bundles_keep_their_fields():
    bundle = llama_bundle("x", tllama.LLAMA_TINY, 16, params_b=1.5)
    assert bundle.params_b == 1.5
    assert bundle.rules is tsharding.TRANSFORMER_RULES
    assert dataclasses.asdict(get_model("llama3_8b").cfg) == \
        dataclasses.asdict(jllama.LLAMA3_8B)
