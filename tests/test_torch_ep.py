"""The ep axis: MoE bundles on several gloo ranks over dp × fsdp × ep × tp,
on the CPU (tests/torch_dist_workers.py runs the ranks: one process group
of 2, one of 4 and one of 8, each carrying several checks).

- Routing: each data rank routes its own rows of a global gates tensor
  whose probabilities tie often (logits on a grid of three values), at a
  capacity factor of 0.5 that drops tokens, over 2 data ranks (dp, fsdp)
  and 4 (dp2 × fsdp2). The kept mask, laid out in data-rank order, equals
  one process routing the global batch exactly, and each rank's slot plus
  its prefix is the global slot exactly. The planted fault, each rank
  routing its rows apart with their own capacity and order, changes the
  drop set.
- Against one device, in the port: one AdamW step of mixtral_tiny (fp32,
  capacity factor 0.5) at ep2, dp2×ep2 and fsdp2×ep2 under each dispatch:
  the loss within 1e-5 relative and every gradient, the router's included,
  within 2e-2 of its largest magnitude (the bf16 bar of
  test_torch_mixtral.py: the experts compute in bf16, and their partial
  gradients are summed over ep after rounding). Adafactor (a scanned
  Mixtral whose expert leaves factor, the dots_attn policy of
  mixtral_small_af) at ep2 for 3 steps: losses within 1e-4 relative, the
  updates at test_torch_mixtral_train.py's bars.
- Against the JAX package: mixtral_tiny at MeshPlan(dp=2, ep=4) on 8 ranks
  (the reference's own plan, tests/test_models.py) and at
  MeshPlan(ep=2, tp=2) on 4 (mixtral_8x7b's axis mix), 3 AdamW steps from
  one init through the bridge, against the JAX train step at the same
  plan on as many CPU devices: losses within 1e-3 relative, and the
  router-gap guard of test_torch_mixtral_train.py (every token's k-th and
  (k+1)-th router probability more than 1e-4 apart in the ranks' passes).
  After the steps every non-expert parameter is bitwise equal across the
  ep replicas of a data group.
- Checkpoints: ep4 -> one device, one device -> dp2×ep2, ep2 -> ep4, each
  restored bitwise (module and optimizer) and the next step's loss within
  1e-5 of the uninterrupted run's. `TrainSession.resize` of mixtral_tiny
  2 -> 4 -> 1 in place: the state bitwise across each move, the step after
  2 -> 4 equal to the uninterrupted run's, the one after 4 -> 1 within 1e-4
  (a step at ep4 rounds its bf16 expert gradients in another order).
- Plans: mixtral_small, mixtral_small_af and mixtral_8x7b at 1-32 chips
  plan as the reference does, and every parameter's fitted spec is the
  reference's rule's; the experts split over ep on E and over tp on the
  hidden width, the router and the norms whole.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_workers as workers
from tests.torch_parity import assert_close
from vodascheduler_tpu.models import mixtral as jmixtral
from vodascheduler_tpu.models import registry as jregistry
from vodascheduler_tpu.models.registry import ModelBundle as JaxBundle
from vodascheduler_tpu.models.registry import _lm_batch, _lm_fused_loss
from vodascheduler_tpu.parallel import mesh as jmesh
from vodascheduler_tpu.parallel import sharding as jsharding
from vodascheduler_tpu.runtime.train import make_optimizer, make_train_setup
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.models import get_model
from vodascheduler_tpu_torch.models import mixtral as tmixtral
from vodascheduler_tpu_torch.ops import moe_dispatch as tmoe
from vodascheduler_tpu_torch.parallel import sharding as tsharding
from vodascheduler_tpu_torch.runtime.optim import factored_dims
from vodascheduler_tpu_torch.runtime.train import plan_for

BATCH = 8
FACTOR = 0.5  # capacity factor: tokens drop
GRAD_SHARE = 2e-2
LOSS_RTOL = 1e-3
GAP = 1e-4
# test_torch_mixtral_train.py's bars on an Adafactor update: a factored
# leaf's within 1e-2 relative L2; of every leaf at most 2% of the elements
# off by more than 2e-2 of its largest move (an unfactored leaf's first
# update is sign(g), which flips where g is within bf16 noise of 0)
AF_UPDATE_REL = 1e-2
AF_SHARE = 2e-2
DISPATCHES = ("routed", "gather", "dense")
STEP_PLANS = {"ep2": {"ep": 2}, "dp2ep2": {"dp": 2, "ep": 2},
              "fsdp2ep2": {"fsdp": 2, "ep": 2}}
AF = {"optimizer": "adafactor",
      "cfg": {"dim": 128, "mlp_hidden": 256, "num_heads": 2,
              "num_kv_heads": 1, "dispatch": "gather", "scan_layers": True,
              "remat_layers": True, "remat_policy": "dots_attn"}}
# (tokens, experts, top_k, factor, seed) of the routing check, and the data
# axes (dp, fsdp) of each layout
ROUTING = dict(tokens=128, experts=4, top_k=2, capacity_factor=FACTOR,
               seed=3)
ROUTING_LAYOUTS = {"dp2": [2, 1], "fsdp2": [1, 2], "dp2fsdp2": [2, 2]}
# the JAX comparisons: plan, ranks, dispatch
JAX_PLANS = {"dp2ep4": ({"dp": 2, "ep": 4}, 8, "routed"),
             "ep2tp2": ({"ep": 2, "tp": 2}, 4, "gather")}


def _cfg(dispatch):
    return {"dispatch": dispatch, "capacity_factor": FACTOR}


def _one(steps=1, **kwargs):
    return workers.train(0, 1, steps=steps, batch=BATCH,
                         model="mixtral_tiny", **kwargs)


def _jax_run(plan, chips, dispatch, params):
    """3 steps of the JAX train step at `plan` on `chips` CPU devices from
    `params`; the losses and the parameters after."""
    jcfg = dataclasses.replace(jmixtral.MIXTRAL_TINY, dtype="float32",
                               **_cfg(dispatch))
    jbundle = JaxBundle(name="mixtral_tiny", module=jmixtral.Mixtral(jcfg),
                        make_batch=_lm_batch(jcfg.vocab_size, workers.SEQ),
                        loss_fn=_lm_fused_loss,
                        rules=jsharding.TRANSFORMER_RULES,
                        seq_len=workers.SEQ, num_experts=jcfg.num_experts)
    setup = make_train_setup(jbundle, chips, devices=jax.devices()[:chips],
                             plan=jmesh.MeshPlan(**plan),
                             global_batch_size=BATCH)
    state = {"params": jax.tree.map(np.copy, params), "extra": {},
             "opt_state": make_optimizer("adamw", 1e-3).init(params),
             "step": jnp.zeros((), jnp.int32)}
    state = jax.device_put(state, setup.state_shardings)
    losses = []
    for b in workers.lm_batches(jcfg.vocab_size, 3, BATCH):
        jb = jax.device_put({k: jnp.asarray(v, jnp.int32)
                             for k, v in b.items()}, setup.batch_shardings)
        state, loss = setup.train_step(state, jb)
        losses.append(float(loss))
    return losses, bridge.flax_to_state_dict(
        jax.tree.map(np.asarray, state["params"]))


def _jax_init():
    """The JAX mixtral_tiny's init (fp32)."""
    cfg = dataclasses.replace(jmixtral.MIXTRAL_TINY, dtype="float32")
    return jax.tree.map(np.array, jmixtral.Mixtral(cfg).init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, workers.SEQ), jnp.int32))["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every check's runs: one device in this process, the JAX package,
    and one group each of 2, 4 and 8 gloo ranks. This process computes in
    one thread, as the ranks do (torch_dist_workers.main)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _runs(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    one = {d: _one(cfg=_cfg(d)) for d in DISPATCHES}
    params = str(tmp / "one_params.pt")
    torch.save(one["gather"]["before"], params)
    one_af = _one(3, **AF)
    af_params = str(tmp / "af_params.pt")
    torch.save(one_af["before"], af_params)
    ckpt = {name: str(tmp / f"ckpt_{name}") for name in ("one", "ep2", "ep4")}
    one_ckpt = _one(3, cfg=_cfg("gather"), save_to=ckpt["one"],
                    save_after=2)

    jax_init = _jax_init()
    jax_params = str(tmp / "jax_params.pt")
    torch.save(bridge.flax_to_state_dict(jax_init), jax_params)
    jax_runs = {name: _jax_run(plan, chips, dispatch, jax_init)
                for name, (plan, chips, dispatch) in JAX_PLANS.items()}

    def step_jobs(plans):
        return [[f"step_{p}_{d}", "train",
                 dict(plan=STEP_PLANS[p], params=params, batch=BATCH,
                      model="mixtral_tiny", cfg=_cfg(d))]
                for p in plans for d in DISPATCHES]

    def jax_job(name):
        plan, _, dispatch = JAX_PLANS[name]
        return [f"jax_{name}", "train",
                dict(plan=plan, params=jax_params, steps=3, batch=BATCH,
                     model="mixtral_tiny", cfg=_cfg(dispatch), gaps=True)]

    def ckpt_job(name, plan, **kwargs):
        return [name, "train", dict(plan=plan, steps=kwargs.pop("steps", 3),
                                    batch=BATCH, model="mixtral_tiny",
                                    cfg=_cfg("gather"), **kwargs)]

    two = workers.run_ranks("jobs", 2, tmp, deadline=240.0, todo=(
        [[f"routing_{n}", "routing", dict(data_shape=s, **ROUTING)]
         for n, s in ROUTING_LAYOUTS.items() if n != "dp2fsdp2"]
        + step_jobs(["ep2"])
        + [["af_ep2", "train", dict(plan={"ep": 2}, params=af_params,
                                     steps=3, batch=BATCH,
                                     model="mixtral_tiny", **AF)],
           ckpt_job("save_ep2", {"ep": 2}, save_to=ckpt["ep2"],
                    save_after=2)]))
    story = [["steps", 1], ["state"], ["resize", 4, None], ["state"],
             ["steps", 1], ["state"], ["resize", 1, None], ["state"],
             ["steps", 1]]
    four = workers.run_ranks("jobs", 4, tmp, deadline=300.0, todo=(
        [["routing_dp2fsdp2", "routing",
          dict(data_shape=ROUTING_LAYOUTS["dp2fsdp2"], **ROUTING)]]
        + step_jobs(["dp2ep2", "fsdp2ep2"])
        + [jax_job("ep2tp2"),
           ckpt_job("save_ep4", {"ep": 4}, save_to=ckpt["ep4"],
                    save_after=2),
           ckpt_job("resume_ep4", {"ep": 4}, steps=1,
                    resume_from=ckpt["ep2"]),
           ckpt_job("resume_dp2ep2", {"dp": 2, "ep": 2}, steps=1,
                    resume_from=ckpt["one"]),
           ["resize", "resize_story",
            dict(chips=2, actions=story, batch=BATCH, model="mixtral_tiny",
                 cfg=_cfg("gather"))],
           ["straight", "resize_story",
            dict(chips=2, actions=[["steps", 3]], batch=BATCH,
                 model="mixtral_tiny", cfg=_cfg("gather"))]]))
    eight = workers.run_ranks("jobs", 8, tmp, deadline=180.0,
                              todo=[jax_job("dp2ep4")])
    resumed_one = _one(1, cfg=_cfg("gather"), resume_from=ckpt["ep4"])
    return {"one": one, "one_af": one_af, "one_ckpt": one_ckpt,
            "resumed_one": resumed_one, "jax": jax_runs,
            "ranks": {2: two, 4: four, 8: eight}}


# ---- routing ---------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(ROUTING_LAYOUTS))
def test_prefix_routing_is_the_global_routing(runs, layout):
    world = int(np.prod(ROUTING_LAYOUTS[layout]))
    ranks = sorted((r[f"routing_{layout}"] for r in runs["ranks"][world]),
                   key=lambda r: r["data_rank"])
    assert [r["data_rank"] for r in ranks] == list(range(world))
    gates = workers.routing_gates(ROUTING["tokens"], ROUTING["experts"],
                                  ROUTING["top_k"], ROUTING["seed"])
    probs = torch.softmax(torch.tensor(np.random.default_rng(
        ROUTING["seed"]).integers(0, 3, gates.shape) / 2.0,
        dtype=torch.float32), -1)
    top = torch.sort(probs, -1, descending=True)[0]
    assert (top[:, 1] == top[:, 2]).any()  # ties at the k-th choice
    capacity = tmoe.expert_capacity(ROUTING["tokens"], ROUTING["experts"],
                                    ROUTING["top_k"], FACTOR)
    pos, kept = tmoe._slot_positions(gates, capacity)
    got_kept = torch.cat([r["kept"] for r in ranks])
    got_pos = torch.cat([r["pos"] + r["prefix"] for r in ranks])
    assert torch.equal(got_kept, kept), layout
    assert torch.equal(got_pos, pos), layout
    assert int((gates > 0).sum() - kept.sum()) > 0  # tokens drop
    rows = ROUTING["tokens"] // world
    assert all(r["slots"] == min(capacity, rows) for r in ranks)
    # the planted fault: each rank's rows routed apart
    apart = torch.cat([r["apart"] for r in ranks])
    assert not torch.equal(apart, kept), layout


# ---- against one device ----------------------------------------------------


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("plan", sorted(STEP_PLANS))
def test_one_step_equals_one_devices(runs, plan, dispatch):
    world = int(np.prod(list(STEP_PLANS[plan].values())))
    rank0 = runs["ranks"][world][0][f"step_{plan}_{dispatch}"]
    one = runs["one"][dispatch]
    tag = f"{plan} {dispatch}"
    assert_close(f"{tag} loss", rank0["losses"][0], one["losses"][0],
                 atol=0, rtol=1e-5)
    assert set(rank0["grads"]) == set(one["grads"])
    assert any(k.endswith("moe.router.weight") for k in one["grads"])
    for key, want in one["grads"].items():
        scale = want.abs().max().item()
        assert scale > 0, key
        assert_close(f"{tag} grad {key}", rank0["grads"][key], want,
                     atol=GRAD_SHARE * scale, rtol=0)
    for key, split in rank0["placements"].items():
        if ".experts_" in key:
            assert split.get("ep") == 0, (key, split)
        else:
            assert "ep" not in split, key


def test_adafactor_at_ep2_equals_one_devices(runs):
    rank0 = runs["ranks"][2][0]["af_ep2"]
    one = runs["one_af"]
    for i, (got, want) in enumerate(zip(rank0["losses"], one["losses"])):
        assert_close(f"adafactor ep2 loss step {i}", got, want, atol=0,
                     rtol=1e-4)
    cfg = dataclasses.replace(tmixtral.MIXTRAL_TINY, **AF["cfg"])
    module = tmixtral.Mixtral(cfg, device="meta")
    factored = {name for g in bridge.reference_param_groups(
        module.named_parameters(), cfg) if factored_dims(g["shape"])
        for name, p in module.named_parameters()
        if any(p is q for q in g["params"])}
    assert any(".experts_" in name for name in factored)
    for key, want in one["after"].items():
        move = want - one["before"][key]
        err = (rank0["after"][key] - want).abs()
        rel = (err.norm() / move.norm()).item()
        share = (err > AF_SHARE * move.abs().max()).float().mean().item()
        print(f"parity adafactor ep2 update {key}: rel_l2={rel:.3g} "
              f"share_off={share:.3g}")
        assert share <= AF_SHARE, key
        if key in factored:
            assert rel <= AF_UPDATE_REL, key
    assert rank0["placements"]["layers.0.moe.experts_down_kernel"] == {
        "ep": 0}


# ---- against the JAX package -----------------------------------------------


def _coordinates(plan):
    sizes = [plan.get(a, 1) for a in ("dp", "fsdp", "ep", "tp")]
    return [tuple(int(c) for c in np.unravel_index(r, sizes))
            for r in range(int(np.prod(sizes)))]


@pytest.mark.parametrize("name", sorted(JAX_PLANS))
def test_ranks_track_the_jax_package(runs, name):
    plan, world, _ = JAX_PLANS[name]
    ranks = [r[f"jax_{name}"] for r in runs["ranks"][world]]
    jlosses, _ = runs["jax"][name]
    for i, (got, want) in enumerate(zip(ranks[0]["losses"], jlosses)):
        assert_close(f"{name} loss step {i}", got, want, atol=0,
                     rtol=LOSS_RTOL)
    assert len(ranks[0]["losses"]) == 3
    assert min(min(r["gaps"]) for r in ranks) > GAP
    want = tsharding.param_placements(
        tmixtral.Mixtral(dataclasses.replace(tmixtral.MIXTRAL_TINY,
                                             dtype="float32"),
                         device="meta"),
        tsharding.TRANSFORMER_RULES,
        {a: plan.get(a, 1) for a in ("dp", "fsdp", "ep", "tp")})
    for key, split in ranks[0]["placements"].items():
        for axis in ("ep", "tp"):
            assert split.get(axis) == want[key]["split"].get(axis), key


@pytest.mark.parametrize("name", sorted(JAX_PLANS))
def test_ep_replicas_hold_bitwise_equal_parameters(runs, name):
    plan, world, _ = JAX_PLANS[name]
    ranks = [r[f"jax_{name}"]["local"] for r in runs["ranks"][world]]
    coords = _coordinates(plan)
    pairs = 0
    for a in range(world):
        for b in range(a + 1, world):
            da, db = coords[a], coords[b]
            if (da[0], da[1], da[3]) != (db[0], db[1], db[3]):
                continue
            for key, t in ranks[a].items():
                if ".experts_" not in key:
                    assert torch.equal(t, ranks[b][key]), (name, a, b, key)
                    pairs += 1
    assert pairs > 0


# ---- checkpoints and the in-place resize -----------------------------------


def _bitwise(got, want, what):
    assert set(got) == set(want) and got, what
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, f"{what}: {bad[:5]}"


@pytest.mark.parametrize("move", ["ep4_to_one", "one_to_dp2ep2",
                                  "ep2_to_ep4"])
def test_checkpoints_across_ep_sizes_restore_bitwise(runs, move):
    saved, resumed = {
        "ep4_to_one": (runs["ranks"][4][0]["save_ep4"],
                       runs["resumed_one"]),
        "one_to_dp2ep2": (runs["one_ckpt"],
                          runs["ranks"][4][0]["resume_dp2ep2"]),
        "ep2_to_ep4": (runs["ranks"][2][0]["save_ep2"],
                       runs["ranks"][4][0]["resume_ep4"]),
    }[move]
    assert any(k.endswith("/exp_avg_sq") for k in saved["saved"])
    _bitwise(resumed["restored"], saved["saved"], move)
    assert_close(f"{move} next loss", resumed["losses"][0],
                 saved["losses"][2], atol=0, rtol=1e-5)


def test_in_place_resize_2_4_1_moves_the_state_bitwise(runs):
    records = runs["ranks"][4][0]["resize"]
    states = [r for r in records if not {"losses", "chips"} & set(r)]
    before_4, at_4, before_1, at_1 = states
    _bitwise(at_4, before_4, "2 -> 4")
    _bitwise(at_1, before_1, "4 -> 1")
    ones = dict.fromkeys(("dp", "fsdp", "tp", "sp", "ep", "pp"), 1)
    assert [r["plan"] for r in records if "plan" in r] == [
        {**ones, "ep": 4}, ones]
    losses = [r["losses"] for r in records if "losses" in r]
    straight = runs["ranks"][4][0]["straight"][0]["losses"]
    assert losses[0] == straight[:1] and losses[1] == straight[1:2]
    assert_close("resize 4 -> 1 next loss", losses[2][0], straight[2],
                 atol=0, rtol=1e-4)
    # rank 3 joined at 4 and left at 1
    assert [r.get("active") for r in runs["ranks"][4][3]["resize"]
            if "chips" in r] == [True, False]


# ---- plans -----------------------------------------------------------------


def _jax_shapes(cfg):
    model = jmixtral.Mixtral(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    return {jsharding._path_str(path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("name", ["mixtral_small", "mixtral_small_af",
                                  "mixtral_8x7b"])
def test_plans_and_placements_equal_the_references(name):
    bundle, ref = get_model(name), jregistry.get_model(name)
    assert dataclasses.asdict(bundle.cfg) == dataclasses.asdict(
        ref.module.cfg)
    assert (bundle.params_b, bundle.seq_len, bundle.num_experts,
            bundle.optimizer) == (ref.params_b, ref.seq_len,
                                  ref.num_experts, ref.optimizer)
    if name == "mixtral_8x7b":
        assert dataclasses.asdict(bundle.cfg) == dataclasses.asdict(
            tmixtral.MIXTRAL_8X7B_LIKE)
    module = tmixtral.Mixtral(bundle.cfg, device="meta")
    ref_shapes = _jax_shapes(ref.module.cfg)
    leaves = tsharding.reference_leaves(module)
    assert {leaf.path for leaf in leaves.values()} == set(ref_shapes)
    for chips in range(1, 33):
        want = jmesh.plan_mesh(chips, model_params_b=ref.params_b,
                               seq_len=ref.seq_len,
                               num_experts=ref.num_experts)
        got = plan_for(bundle, chips, 64 * chips)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), chips
        sizes = {a: getattr(got, a) for a in ("dp", "fsdp", "ep", "tp")}
        mesh = types.SimpleNamespace(shape=sizes)
        placements = tsharding.param_placements(
            module, tsharding.TRANSFORMER_RULES, sizes)
        for pname, entry in placements.items():
            leaf = entry["leaf"]
            spec = jsharding._fit_spec(
                jsharding.TRANSFORMER_RULES.spec_for(leaf.path),
                ref_shapes[leaf.path], mesh)
            assert entry["spec"] == tuple(spec) + (None,) * (
                len(leaf.shape) - len(spec)), (pname, chips)
            split = entry["split"]
            if ".experts_" in pname:
                if got.ep > 1:
                    assert split["ep"] == 0, (pname, chips)
                if got.tp > 1:
                    assert split["tp"] == (1 if "down" in pname else 2)
            elif "router" in pname or "norm" in pname:
                assert "ep" not in split and "tp" not in split, pname
    assert plan_for(bundle, 8, 8).ep > 1
