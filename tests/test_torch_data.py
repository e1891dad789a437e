"""The port's real data against the JAX package's ``data/real.py``: the
arrays are identical (the port reads the digits from its own copy of the
file scikit-learn ships, with scikit-learn installed or not; without it
the corpus falls back to the pydoc topics in both packages); the batch
functions give identical arrays on the same numpy draws; `eval_classifier`
agrees within 1e-6 (fp32 sums of the loss in another order).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.data import real as jreal
from vodascheduler_tpu.models import mlp as jmlp
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.data import real as treal
from vodascheduler_tpu_torch.models import mlp as tmlp

from tests.torch_parity import assert_close

FIELDS = ("train_x", "train_y", "test_x", "test_y")


def _same_dataset(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_digits_are_the_references():
    _same_dataset(treal.load_digits_dataset(), jreal.load_digits_dataset())
    ds = treal.load_digits_dataset()
    assert ds.train_x.shape == (1438, 8, 8, 1) and ds.num_classes == 10


@pytest.mark.parametrize("test_fraction,seed", [(0.2, 0), (0.1, 3)])
def test_digits_without_sklearn_read_the_same_arrays(monkeypatch,
                                                     test_fraction, seed):
    ref = jreal.load_digits_dataset.__wrapped__(test_fraction, seed)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    got = treal.load_digits_dataset.__wrapped__(test_fraction, seed)
    _same_dataset(got, ref)


def test_corpus_is_the_references():
    got, ref = treal.load_text_corpus(), jreal.load_text_corpus()
    assert got.name == ref.name
    np.testing.assert_array_equal(got.train, ref.train)
    np.testing.assert_array_equal(got.test, ref.test)
    assert got.train.dtype == np.uint8
    assert got.sources == ("pydoc_data.topics",
                           "sklearn.datasets descr/*.rst")


def test_corpus_without_sklearn_is_pydoc_alone_in_both(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    got = treal.load_text_corpus.__wrapped__()
    ref = jreal.load_text_corpus.__wrapped__()
    assert got.sources == ("pydoc_data.topics",)
    np.testing.assert_array_equal(got.train, ref.train)
    np.testing.assert_array_equal(got.test, ref.test)
    assert got.train.size < treal.load_text_corpus().train.size


def _fed(monkeypatch, draws):
    """jax.random.randint returning `draws`, whatever its key."""
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(draws, jnp.int32))


@pytest.mark.parametrize("seq_len", [8, 64])
def test_lm_windows_on_the_same_draws(monkeypatch, seq_len):
    corpus = treal.load_text_corpus()
    n = corpus.train.size
    starts = np.array([0, 17, n - seq_len - 2, 123456])
    _fed(monkeypatch, starts)
    ref = jreal.make_lm_batch_fn(jreal.load_text_corpus(), seq_len)(
        len(starts), jax.random.PRNGKey(0))
    got = treal.lm_windows(torch.from_numpy(corpus.train.astype(np.int64)),
                           torch.from_numpy(starts), seq_len)
    for k in ("inputs", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_lm_batch_draws_in_range_and_is_a_function_of_the_generator():
    make = treal.make_lm_batch_fn(treal.load_text_corpus(), 32)
    a = make(5, torch.Generator().manual_seed(4))
    b = make(5, torch.Generator().manual_seed(4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["inputs"].shape == (5, 32) and a["inputs"].dtype == torch.int64
    assert torch.equal(a["inputs"][:, 1:], a["targets"][:, :-1])
    with pytest.raises(ValueError, match="too small"):
        treal.make_lm_batch_fn(treal.TextCorpus("t", np.zeros(8, np.uint8),
                                                np.zeros(0, np.uint8)), 8)


def test_sampling_on_the_same_draws(monkeypatch):
    ds = treal.load_digits_dataset()
    idx = np.array([0, 5, ds.num_train - 1, 5, 700])
    _fed(monkeypatch, idx)
    ref = jreal.make_sampling_batch_fn(jreal.load_digits_dataset())(
        len(idx), jax.random.PRNGKey(0))
    got = treal.sample_batch(torch.from_numpy(ds.train_x),
                             torch.from_numpy(ds.train_y), torch.from_numpy(idx))
    np.testing.assert_array_equal(got["images"].numpy(),
                                  np.asarray(ref["images"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    batch = treal.make_sampling_batch_fn(ds)(6, torch.Generator().manual_seed(1))
    assert batch["images"].shape == (6, 8, 8, 1)
    assert batch["labels"].dtype == torch.int64


@pytest.mark.parametrize("batch_size", [512, 100])
def test_eval_classifier_matches(batch_size):
    ds = jreal.load_digits_dataset()
    model = jmlp.Mlp(jmlp.DIGITS_MLP)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, 8, 1)))["params"])
    ref = jreal.eval_classifier(lambda p, x: model.apply({"params": p}, x),
                                params, ds, batch_size)
    mod = tmlp.Mlp(tmlp.DIGITS_MLP)
    mod.load_state_dict(bridge.mlp_to_state_dict(params))
    got = treal.eval_classifier(mod, treal.load_digits_dataset(), batch_size)
    assert_close("eval_classifier loss", got["loss"], ref["loss"],
                 atol=1e-6, rtol=1e-6)
    assert got["accuracy"] == ref["accuracy"]
