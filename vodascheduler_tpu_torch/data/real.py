"""Real datasets with a restart-stable batch stream.

Counterpart of the JAX package's ``data/real.py``. The arrays are the
reference's, byte for byte: the same sources, order and split. A batch is a
pure function of its generator, and `TrainSession` seeds the generator of
each step from (seed, step), so a resumed job sees the batches an
uninterrupted one would have seen. Each batch maker is split in two: a draw
from the generator (start offsets, or indices) and a pure function of the
draw (`lm_windows`, `sample_batch`), so that a test can feed one set of
numpy draws to both packages.

The digits are read from the file kept beside this module
(``digits.csv.gz``: the UCI handwritten digits as scikit-learn ships
them, which the reference reads), parsed as scikit-learn parses it, so
every machine trains on the reference's arrays with or without
scikit-learn. Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DIGITS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits.csv.gz")


@dataclasses.dataclass(frozen=True)
class RealDataset:
    """An in-memory supervised dataset with a deterministic split."""

    name: str
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray

    @property
    def num_train(self) -> int:
        return int(self.train_x.shape[0])

    @property
    def num_classes(self) -> int:
        return int(self.train_y.max()) + 1


@functools.lru_cache(maxsize=None)
def load_digits_dataset(test_fraction: float = 0.2,
                        seed: int = 0) -> RealDataset:
    """The UCI handwritten-digits dataset (1,797 real 8x8 images):
    deterministic permutation split, pixels scaled to [0, 1], images
    [N, 8, 8, 1] float32 and labels int32, as the reference gives them."""
    data = np.loadtxt(DIGITS_CSV, delimiter=",")
    images = (data[:, :-1].reshape(-1, 8, 8).astype(np.float32) / 16.0)[
        ..., None]
    labels = data[:, -1].astype(np.int32)
    perm = np.random.RandomState(seed).permutation(images.shape[0])
    images, labels = images[perm], labels[perm]
    n_test = int(images.shape[0] * test_fraction)
    return RealDataset(
        name="digits",
        train_x=images[n_test:], train_y=labels[n_test:],
        test_x=images[:n_test], test_y=labels[:n_test])


@dataclasses.dataclass(frozen=True)
class TextCorpus:
    """A byte-level LM corpus with a deterministic holdout tail."""

    name: str
    train: np.ndarray  # uint8
    test: np.ndarray
    sources: Tuple[str, ...] = ()  # the parts it was built from, in order


@functools.lru_cache(maxsize=None)
def load_text_corpus(test_fraction: float = 0.05) -> TextCorpus:
    """Real English prose, byte-level: the Python documentation topics
    bundled in the standard library (pydoc_data), then scikit-learn's
    dataset descriptions where scikit-learn is installed. `sources` says
    which were used; without scikit-learn the pydoc topics alone make the
    corpus, as in the reference. Fixed source list, sorted traversal,
    head/tail split."""
    from pydoc_data import topics

    parts = [topics.topics[k] for k in sorted(topics.topics)]
    sources = ("pydoc_data.topics",)
    try:
        import sklearn.datasets as skd
        descr = os.path.join(os.path.dirname(skd.__file__), "descr")
        for fname in sorted(os.listdir(descr)):
            if fname.endswith(".rst"):
                with open(os.path.join(descr, fname), errors="replace") as f:
                    parts.append(f.read())
        sources += ("sklearn.datasets descr/*.rst",)
    except Exception:
        pass  # no scikit-learn, or its layout changed: pydoc alone
    data = np.frombuffer("\n\n".join(parts).encode("utf-8"),
                         dtype=np.uint8)
    n_test = int(data.size * test_fraction)
    split = data.size - n_test  # n_test may be 0: slice by index, not -0
    return TextCorpus(name="pydoc-bytes", train=data[:split].copy(),
                      test=data[split:].copy(), sources=sources)


class _OnDevice:
    """numpy arrays as tensors, copied to each device once, at first use."""

    def __init__(self, *arrays: np.ndarray):
        self._cpu = tuple(torch.from_numpy(np.ascontiguousarray(a))
                          for a in arrays)
        self._by_device: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        device = torch.device(device)
        if device not in self._by_device:
            self._by_device[device] = tuple(t.to(device) for t in self._cpu)
        return self._by_device[device]


def lm_windows(data: torch.Tensor, starts: torch.Tensor,
               seq_len: int) -> Dict[str, torch.Tensor]:
    """The LM batch of windows of `data` at `starts`: inputs
    data[s : s + seq_len], targets shifted by one."""
    idx = starts[:, None] + torch.arange(seq_len + 1,
                                         device=starts.device)[None, :]
    windows = data[idx]
    return {"inputs": windows[:, :-1], "targets": windows[:, 1:]}


def make_lm_batch_fn(
        corpus: TextCorpus,
        seq_len: int) -> Callable[[int, torch.Generator], Dict[str, Any]]:
    """ModelBundle.make_batch over real text: window starts drawn uniformly
    from [0, n - seq_len - 1) by the generator, then `lm_windows`. Tokens
    are int64 bytes on the generator's device."""
    n = int(corpus.train.size)
    if n <= seq_len + 1:
        raise ValueError(f"corpus too small ({n}) for seq_len {seq_len}")
    data = _OnDevice(corpus.train.astype(np.int64))

    def make(batch_size: int, generator: torch.Generator) -> Dict[str, Any]:
        starts = torch.randint(0, n - seq_len - 1, (batch_size,),
                               generator=generator, device=generator.device)
        return lm_windows(data.on(generator.device)[0], starts, seq_len)

    return make


def sample_batch(x: torch.Tensor, y: torch.Tensor,
                 idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The classifier batch of rows `idx`."""
    return {"images": x[idx], "labels": y[idx]}


def make_sampling_batch_fn(
        dataset: RealDataset
) -> Callable[[int, torch.Generator], Dict[str, Any]]:
    """ModelBundle.make_batch over real data: indices drawn uniformly from
    the training rows by the generator, then `sample_batch`. Images fp32,
    labels int64, on the generator's device."""
    arrays = _OnDevice(dataset.train_x, dataset.train_y.astype(np.int64))
    n = dataset.num_train

    def make(batch_size: int, generator: torch.Generator) -> Dict[str, Any]:
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=generator.device)
        return sample_batch(*arrays.on(generator.device), idx)

    return make


@torch.no_grad()
def eval_classifier(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                    dataset: RealDataset, batch_size: int = 512,
                    device: Any = "cpu") -> Dict[str, float]:
    """Held-out loss and accuracy of `apply_fn` (images -> logits, e.g. the
    module) over the test split, in batches of `batch_size` on `device`."""
    loss_sum, correct, total = 0.0, 0, 0
    for i in range(0, dataset.test_x.shape[0], batch_size):
        x = torch.from_numpy(dataset.test_x[i:i + batch_size]).to(device)
        y = torch.from_numpy(dataset.test_y[i:i + batch_size].astype(
            np.int64)).to(device)
        logits = apply_fn(x).float()
        loss_sum += float(F.cross_entropy(logits, y, reduction="sum"))
        correct += int((logits.argmax(-1) == y).sum())
        total += int(y.shape[0])
    return {"loss": loss_sum / total, "accuracy": correct / total}
