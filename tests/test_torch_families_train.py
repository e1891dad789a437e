"""Training parity of the families: three AdamW steps of the port's
TrainSession against the JAX package's `train_step_raw`, from the same
bridged init, in fp32 on the CPU, on the same numpy batches, for
resnet_tiny (with its BatchNorm statistics), bert_tiny and digits_mlp
(the real digits data); a llama_tiny_text step on the real corpus; and the
registry against the reference's.

Tolerance: losses at rtol 1e-4, parameters after three steps at atol 1e-4
(fp32 sums in another order, amplified by Adam's normalisation of small
gradients), as tests/test_torch_train.py holds Llama. One exception, with
its reason: an element whose reference gradient at some step is below
TINY_GRAD (1e-7) in magnitude, but not 0 (a gradient that is exactly 0,
as at the digits' blank border pixels, moves both packages alike). There Adam's first update, lr·g/(|g| +
1e-8), turns the last bits of an fp32 gradient into up to lr (1e-3) of
movement, so a gradient of 2e-9 in one package and 1.4e-8 in the other
(3e-8 apart, within the forward tests' 1e-5) moves the element 7.6e-4
apart (bert_tiny's layer_0 q_proj at this seed). Such elements are held at
STEPS·lr, and there must be few of them (one, or 1% of a tensor). The
BatchNorm statistics are held exactly: no step may change them, in either
package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.data import load_digits_dataset as jax_digits
from vodascheduler_tpu.data import load_text_corpus as jax_corpus
from vodascheduler_tpu.models import bert as jbert
from vodascheduler_tpu.models import llama as jllama
from vodascheduler_tpu.models import mlp as jmlp
from vodascheduler_tpu.models import registry as jreg
from vodascheduler_tpu.models import resnet as jresnet
from vodascheduler_tpu.parallel.sharding import CONV_RULES, TRANSFORMER_RULES
from vodascheduler_tpu.runtime.train import make_optimizer as jax_optimizer
from vodascheduler_tpu.runtime.train import make_train_setup
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.data import load_digits_dataset
from vodascheduler_tpu_torch.models import bert as tbert
from vodascheduler_tpu_torch.models import llama as tllama
from vodascheduler_tpu_torch.models import mlp as tmlp
from vodascheduler_tpu_torch.models import registry as treg
from vodascheduler_tpu_torch.models import resnet as tresnet
from vodascheduler_tpu_torch.runtime import TrainSession

from tests.torch_parity import assert_close

BATCH, STEPS = 4, 3
LR, TINY_GRAD = 1e-3, 1e-7


def _jax_state(jbundle, params, stats):
    return {"params": params,
            "extra": {} if stats is None else {"batch_stats": stats},
            "opt_state": jax_optimizer("adamw", 1e-3).init(params),
            "step": jnp.zeros((), jnp.int32)}


def _stats_away_from_init(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key
                         == "var" else 0.1 * rng.standard_normal(v.shape)
                         ).astype(np.float32), stats)


def _case(name):
    """(jax bundle, port bundle, batches as numpy dicts)."""
    rng = np.random.default_rng(0)
    if name == "resnet_tiny":
        jcfg = dataclasses.replace(jresnet.RESNET_TINY, dtype="float32")
        tcfg = dataclasses.replace(tresnet.RESNET_TINY, dtype="float32")
        jb = jreg.ModelBundle(name=name, module=jresnet.ResNet(jcfg),
                              make_batch=jreg._image_batch(32, 3, 10),
                              loss_fn=jreg._cls_loss, rules=CONV_RULES,
                              has_batch_stats=True)
        tb = treg.family_bundle(name, tresnet.ResNet, tcfg,
                                treg._image_batch(32, 3, 10), treg._cls_loss)
        batches = [{"images": rng.standard_normal((BATCH, 32, 32, 3)).astype(
            np.float32), "labels": rng.integers(0, 10, BATCH)}
            for _ in range(STEPS)]
    elif name == "bert_tiny":
        jcfg = dataclasses.replace(jbert.BERT_TINY, dtype="float32")
        tcfg = dataclasses.replace(tbert.BERT_TINY, dtype="float32")
        jb = jreg.ModelBundle(name=name, module=jbert.Bert(jcfg),
                              make_batch=jreg._lm_batch(jcfg.vocab_size, 16),
                              loss_fn=jreg._mlm_loss,
                              rules=TRANSFORMER_RULES, seq_len=16)
        tb = treg.family_bundle(name, tbert.Bert, tcfg,
                                treg._lm_batch(tcfg.vocab_size, 16),
                                treg._mlm_loss, seq_len=16)
        batches = []
        for _ in range(STEPS):
            t = rng.integers(0, jcfg.vocab_size, (BATCH, 17))
            batches.append({"inputs": t[:, :-1], "targets": t[:, 1:]})
    else:  # digits_mlp, on the real digits
        jb = jreg.get_model("digits_mlp")
        tb = treg.get_model("digits_mlp")
        ds = load_digits_dataset()
        batches = []
        for _ in range(STEPS):
            idx = rng.integers(0, ds.num_train, BATCH)
            batches.append({"images": ds.train_x[idx],
                            "labels": ds.train_y[idx]})
    return jb, tb, batches


@pytest.mark.parametrize("name", ["resnet_tiny", "bert_tiny", "digits_mlp"])
def test_three_adamw_steps_match_jax(name):
    jb, tb, batches = _case(name)
    setup = make_train_setup(jb, num_chips=1, devices=jax.devices()[:1],
                             global_batch_size=BATCH)
    key = "images" if "images" in batches[0] else "inputs"
    kw = {"train": False} if jb.has_batch_stats else {}
    variables = jb.module.init(jax.random.PRNGKey(0),
                               jnp.asarray(batches[0][key]), **kw)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = (_stats_away_from_init(jax.tree.map(
        np.asarray, variables["batch_stats"]), 1)
        if jb.has_batch_stats else None)
    state = _jax_state(jb, params, stats)
    step = jax.jit(setup.train_step_raw)
    extra = {} if stats is None else {"batch_stats": stats}
    grad = jax.jit(jax.grad(lambda p, b: jb.loss_fn(
        lambda pp, x: jb.module.apply({"params": pp, **extra}, x, **kw),
        p, b)))
    near_zero = None  # elements whose reference gradient was ever tiny

    session = TrainSession(tb, global_batch_size=BATCH, device="cpu")
    session.module.load_state_dict(bridge.tree_to_state_dict(params, stats))
    buffers0 = {n: b.clone() for n, b in session.module.named_buffers()}
    assert treg.input_key(batches[0]) == key

    for i, b in enumerate(batches):
        jbatch = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                                 else jnp.float32) for k, v in b.items()}
        tbatch = {k: torch.tensor(v).long() if v.dtype.kind == "i"
                  else torch.tensor(v) for k, v in b.items()}
        g = jax.tree.map(lambda a: (np.abs(np.asarray(a)) < TINY_GRAD)
                         & (np.asarray(a) != 0), grad(state["params"], jbatch))
        near_zero = g if near_zero is None else jax.tree.map(
            np.logical_or, near_zero, g)
        state, jloss = step(state, jbatch)
        tloss = session.train_step(tbatch)
        assert_close(f"{name} train loss step {i}", tloss.item(),
                     float(jloss), atol=0, rtol=1e-4)
    ref = bridge.tree_to_state_dict(
        jax.tree.map(np.asarray, state["params"]),
        None if stats is None else jax.tree.map(
            np.asarray, state["extra"]["batch_stats"]))
    tiny = bridge.tree_to_state_dict(near_zero)
    for k, p in session.module.state_dict().items():
        small = tiny[k].numpy() if k in tiny else np.zeros(p.shape, bool)
        assert small.sum() <= max(1, small.size // 100), (k, small.sum())
        got, want = p.numpy(), ref[k].numpy()
        assert_close(f"{name} params after {STEPS} steps {k}",
                     got[~small], want[~small], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[small], want[small], atol=STEPS * LR,
                                   rtol=0, err_msg=k)
    # BatchNorm statistics: unchanged in both packages
    for n, b in session.module.named_buffers():
        assert torch.equal(b, buffers0[n]), n
        np.testing.assert_array_equal(ref[n].numpy(), buffers0[n].numpy())
    if stats is not None:
        assert len(buffers0) == 2 * sum(
            1 for m in session.module.modules()
            if isinstance(m, tresnet.BatchNorm))


def test_llama_tiny_text_step_matches_jax():
    """One TrainSession step of llama_tiny_text (fp32) on a batch of the
    real corpus, windows at the same numpy starts in both packages."""
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, dtype="float32")
    tcfg = dataclasses.replace(tllama.LLAMA_TINY, dtype="float32")
    jb = jreg._text_lm_bundle("llama_tiny_text", jcfg, seq_len=64)
    tb = treg._text_lm_bundle("llama_tiny_text", tcfg, 64)
    corpus = jax_corpus()
    starts = np.random.default_rng(3).integers(
        0, corpus.train.size - 65, BATCH)
    windows = np.stack([corpus.train[s:s + 65] for s in starts]).astype(
        np.int64)
    setup = make_train_setup(jb, num_chips=1, devices=jax.devices()[:1],
                             global_batch_size=BATCH)
    params = jax.tree.map(np.asarray, jb.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32))["params"])
    state, jloss = jax.jit(setup.train_step_raw)(
        _jax_state(jb, params, None),
        {"inputs": jnp.asarray(windows[:, :-1], jnp.int32),
         "targets": jnp.asarray(windows[:, 1:], jnp.int32)})
    session = TrainSession(tb, global_batch_size=BATCH, device="cpu")
    session.module.load_state_dict(bridge.flax_to_state_dict(params))
    tloss = session.train_step({"inputs": torch.tensor(windows[:, :-1]),
                                "targets": torch.tensor(windows[:, 1:])})
    assert_close("llama_tiny_text step loss", tloss.item(), float(jloss),
                 atol=0, rtol=1e-4)
    ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray,
                                                 state["params"]))
    for k, p in session.module.state_dict().items():
        assert_close(f"llama_tiny_text params after a step {k}", p, ref[k],
                     atol=1e-4, rtol=0)
    # the session's own batches are windows of the same corpus
    batch = session.make_batch()
    assert batch["inputs"].shape == (BATCH, 64)
    assert torch.equal(batch["inputs"][:, 1:], batch["targets"][:, :-1])


def test_registry_matches_the_reference():
    """Every bundle of the reference (mixtral_8x7b since the ep axis), the
    aliases, and each bundle's config, sequence length and optimizer.
    The port's bundles have no `has_batch_stats`: a BatchNorm model keeps
    its statistics as module buffers, which the checkpoint and the step
    treat like any other model's, so the reference's flag stands exactly
    for the ResNet configs."""
    assert set(treg.MODEL_REGISTRY) == set(jreg.MODEL_REGISTRY)
    assert not treg._NOT_PORTED
    assert treg._ALIASES == jreg._ALIASES
    for name in treg.MODEL_REGISTRY:
        ref, got = jreg.get_model(name), treg.get_model(name)
        assert got.name == ref.name == name
        assert dataclasses.asdict(got.cfg) == dataclasses.asdict(
            ref.module.cfg), name
        assert (got.seq_len, got.optimizer) == (ref.seq_len,
                                                ref.optimizer), name
        assert ref.has_batch_stats == isinstance(got.cfg,
                                                 tresnet.ResNetConfig), name
    for alias in ("bert", "vitl", "nmt", "transformer_nmt"):
        assert treg.get_model(alias).name == jreg.get_model(alias).name
    for name in ("llama3_8b", "llama8b"):  # in MODEL_REGISTRY since A10
        assert dataclasses.asdict(treg.get_model(name).cfg) == \
            dataclasses.asdict(jreg.get_model(name).module.cfg)
    for name in ("mixtral_8x7b", "mixtral"):  # in MODEL_REGISTRY since ep
        assert dataclasses.asdict(treg.get_model(name).cfg) == \
            dataclasses.asdict(jreg.get_model(name).module.cfg)


@pytest.mark.parametrize("name", ["mnist_mlp", "resnet_tiny", "bert_tiny",
                                  "vit_tiny", "nmt_tiny", "digits_mlp",
                                  "llama_tiny_text"])
def test_bundle_batches_have_the_reference_shapes(name):
    ref = jreg.get_model(name)
    got = treg.get_model(name)
    jbatch = ref.make_batch(3, jax.random.PRNGKey(0))
    tbatch = got.make_batch(3, torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jbatch)[0]
    # the module's input is where the reference's runtime looks for it
    assert treg.input_key(tbatch) == ("images" if "images" in jbatch
                                      else "inputs")
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.asarray(t.shape), tbatch,
                     is_leaf=torch.is_tensor))[0])
    assert len(jflat) == len(tflat)
    for path, leaf in jflat:
        assert tuple(tflat[path]) == leaf.shape, (name, path)
    # and the model takes it: a finite loss
    session = TrainSession(got, global_batch_size=2, device="cpu")
    with torch.no_grad():
        assert np.isfinite(float(got.loss_fn(session.module,
                                             session.make_batch())))


def test_digits_bundles_read_the_same_data():
    assert all(np.array_equal(getattr(load_digits_dataset(), f),
                              getattr(jax_digits(), f))
               for f in ("train_x", "train_y", "test_x", "test_y"))
