"""Real-dataset path for training jobs: the JAX package's ``data/``, for
PyTorch. Every dataset here ships with the repo or inside packages already
installed; nothing is downloaded."""

from vodascheduler_tpu_torch.data.real import (
    RealDataset,
    TextCorpus,
    eval_classifier,
    lm_windows,
    load_digits_dataset,
    load_text_corpus,
    make_lm_batch_fn,
    make_sampling_batch_fn,
    sample_batch,
)

__all__ = [
    "RealDataset",
    "TextCorpus",
    "eval_classifier",
    "lm_windows",
    "load_digits_dataset",
    "load_text_corpus",
    "make_lm_batch_fn",
    "make_sampling_batch_fn",
    "sample_batch",
]
