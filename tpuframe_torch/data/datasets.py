"""Dataset builders (counterpart of ``tpuframe/data/datasets.py``).

Numpy only, a local copy of what the ported slices need: ``ArrayDataset``,
``lm_text`` and ``imagenet`` with their synthetic generators, which give
the same arrays as the JAX package's from the same arguments.  Rows are
gathered with numpy indexing (the JAX package uses its native C++ gather
for the same rows).  ``tokens.npy`` and the ImageNet ``.npy`` shards are
read from a local ``data_dir``; ``gs://`` paths and the MNIST, CIFAR-10
and GLUE builders are not ported yet (ROADMAP.md queue 1, item 4 and
slice 4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from tpuframe_torch.parallel import collectives

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_GCS = "the GCS reader is ROADMAP.md queue 1, item 4"


@dataclass
class ArrayDataset:
    """In-memory columnar dataset: dict of equal-length arrays."""

    columns: dict[str, np.ndarray]

    def __post_init__(self):
        lens = {k: len(v) for k, v in self.columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged columns: {lens}")

    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    def __getitem__(self, idx) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.columns.items()}

    def shard(self, num_shards: int, index: int) -> "ArrayDataset":
        """Contiguous per-rank shard (DistributedSampler's ``num_replicas
        / rank`` split); the remainder is dropped so shards are equal."""
        if not (0 <= index < num_shards):
            raise ValueError(f"shard index {index} out of range {num_shards}")
        n = len(self) // num_shards
        lo = index * n
        return ArrayDataset({k: v[lo:lo + n] for k, v in self.columns.items()})


def lm_text(data_dir: str | None = None, *, seq_len: int = 2048,
            vocab_size: int = 32000, synthetic_size: int = 256,
            padded_docs: bool = False, pad_id: int = 0):
    """Next-token-prediction chunks: ``input_ids [N, S]``, ``labels [N, S]``
    int32, labels pre-shifted on the host so the loss is positionwise.

    With ``data_dir``: reads ``tokens.npy`` (one int32 token stream) from
    that local directory and chunks it; otherwise an order-2 structured
    synthetic stream, so that the loss can fall well below log(V).

    ``padded_docs``: variable-length documents right-padded to ``seq_len``
    with ``pad_id``; padded label positions carry ``-100`` (ignored: zero
    loss and zero gradient, means over valid tokens only)."""
    if padded_docs:
        if data_dir is not None:
            raise ValueError("padded_docs is a synthetic-data mode; "
                             "pre-tokenized streams are packed, not padded")
        return (_synthetic_lm_docs(synthetic_size, seq_len, vocab_size,
                                   pad_id=pad_id, seed=8),
                _synthetic_lm_docs(max(synthetic_size // 8, 8), seq_len,
                                   vocab_size, pad_id=pad_id, seed=9))
    if data_dir is not None:
        _local(data_dir)
        stream = np.load(os.path.join(data_dir, "tokens.npy"))
        stream = stream.astype(np.int32) % vocab_size
        n = (len(stream) - 1) // seq_len
        split = max(int(0.98 * n), 1)

        def chunk(lo, hi):
            ids = np.stack([stream[i * seq_len:(i + 1) * seq_len]
                            for i in range(lo, hi)])
            lbl = np.stack([stream[i * seq_len + 1:(i + 1) * seq_len + 1]
                            for i in range(lo, hi)])
            return ArrayDataset({"input_ids": ids, "labels": lbl})

        return chunk(0, split), chunk(split, n)
    return (_synthetic_lm(synthetic_size, seq_len, vocab_size, seed=8),
            _synthetic_lm(max(synthetic_size // 8, 8), seq_len, vocab_size,
                          seed=9))


def _synthetic_lm_docs(n, seq_len, vocab_size, *, pad_id, seed):
    """Variable-length affine-recurrence documents, right-padded: lengths
    uniform in [seq_len//4, seq_len]; labels are the shifted next tokens
    inside the document and -100 from the last real token on."""
    rng = np.random.default_rng(seed)
    full = _synthetic_lm(n, seq_len, vocab_size, seed=seed)
    ids = np.array(full[:n]["input_ids"], copy=True)
    labels = np.array(full[:n]["labels"], copy=True)
    lengths = rng.integers(max(seq_len // 4, 2), seq_len + 1, size=n)
    for i, ln in enumerate(lengths):
        ids[i, ln:] = pad_id
        labels[i, ln - 1:] = -100
    return ArrayDataset({"input_ids": ids, "labels": labels})


def _synthetic_lm(n, seq_len, vocab_size, *, seed):
    """Deterministic affine-recurrence token stream x_{t+1} = (31 x_t + 17)
    mod V with 5% noise tokens."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab_size, size=n)
    a, b = 31, 17
    ids = np.empty((n, seq_len + 1), np.int64)
    ids[:, 0] = starts
    for t in range(seq_len):
        ids[:, t + 1] = (a * ids[:, t] + b) % vocab_size
    noise = rng.random((n, seq_len + 1)) < 0.05
    ids[noise] = rng.integers(0, vocab_size, size=int(noise.sum()))
    return ArrayDataset({"input_ids": ids[:, :-1].astype(np.int32),
                         "labels": ids[:, 1:].astype(np.int32)})


def _local(data_dir: str) -> None:
    if "://" in data_dir:
        raise NotImplementedError(f"{data_dir!r}: only local data "
                                  f"directories are ported ({_GCS})")


def imagenet(data_dir: str | None = None, *, image_size: int = 224,
             synthetic_size: int = 512, keep_u8: bool = False,
             num_classes: int = 1000):
    """``image [N, S, S, 3]`` float32 (or uint8 with ``keep_u8``) and
    ``label [N]`` int32 in ``[0, num_classes)``.

    With ``data_dir``: the ``images_XXXXX.npy`` / ``labels_XXXXX.npy``
    shards that ``tpuframe.data.prepare_imagenet`` writes, from a local
    directory; each of several ranks loads every world-th file and marks
    its dataset ``host_presharded``, as each JAX host does.  uint8
    shards are normalised with ImageNet's mean and std unless
    ``keep_u8``; 99% train, 1% eval.  Without: the synthetic class-template
    images (``synthetic_size`` train, an eighth of it, at least 64, eval),
    bit-equal to the JAX package's."""
    if data_dir is not None:
        _local(data_dir)
        world, rank = collectives.world()
        names = sorted(n for n in os.listdir(data_dir)
                       if n.startswith("images_"))
        if world > 1:
            if len(names) % world:
                raise ValueError(f"{len(names)} imagenet shard files not "
                                 f"divisible by {world} ranks")
            names = names[rank::world]
        x = np.concatenate([np.load(os.path.join(data_dir, n))
                            for n in names])
        y = np.concatenate([np.load(os.path.join(
            data_dir, n.replace("images_", "labels_"))) for n in names])
        y = y.astype(np.int32)
        if x.dtype == np.uint8 and not keep_u8:
            x = ((x.astype(np.float32) / 255.0) - IMAGENET_MEAN) \
                / IMAGENET_STD
        split = int(0.99 * len(x))
        train = ArrayDataset({"image": x[:split], "label": y[:split]})
        test = ArrayDataset({"image": x[split:], "label": y[split:]})
        train.host_presharded = test.host_presharded = world > 1
        return train, test
    shape = (image_size, image_size, 3)
    train, test = (
        _synthetic_images(synthetic_size, shape, num_classes, seed=4),
        _synthetic_images(max(synthetic_size // 8, 64), shape, num_classes,
                          seed=5, template_seed=4))
    if keep_u8:
        for ds in (train, test):
            ds.columns["image"] = np.round(
                ds.columns["image"] * 255.0).astype(np.uint8)
    return train, test


def _synthetic_images(n, shape, num_classes, *, seed, template_seed=None):
    """A fixed random template per class plus noise, clipped to [0, 1]
    (mean ~0.5, std ~0.3 like real [0, 1) images): learnable, so a falling
    loss means something.  Train and eval share ``template_seed``."""
    tmpl_rng = np.random.default_rng(seed if template_seed is None
                                     else template_seed)
    templates = tmpl_rng.normal(0.0, 1.0, size=(num_classes, *shape)) \
        .astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    noise = rng.normal(0.0, 1.0, size=(n, *shape)).astype(np.float32)
    x = np.clip(0.5 + 0.25 * templates[labels] + 0.1 * noise, 0.0, 1.0)
    return ArrayDataset({"image": x.astype(np.float32), "label": labels})


BUILDERS = {"lm_text": lm_text, "imagenet": imagenet}
_LATER = {"mnist": "queue 1, item 4 (the MNIST and CIFAR-10 builders)",
          "cifar10": "queue 1, item 4 (the MNIST and CIFAR-10 builders)",
          "glue_sst2": "slice 4 (BERT/GLUE training)",
          "glue_mnli": "slice 4 (BERT/GLUE training)",
          "glue_stsb": "slice 4 (BERT/GLUE training)",
          "glue_cola": "slice 4 (BERT/GLUE training)"}


def check(name: str) -> None:
    """Raise for a ``dataset`` name the port cannot build: not ported yet
    (``NotImplementedError``, naming its ROADMAP.md item) or unknown."""
    if name in _LATER:
        raise NotImplementedError(f"dataset {name!r} is not ported yet: "
                                  f"ROADMAP.md {_LATER[name]}")
    if name not in BUILDERS:
        raise ValueError(f"unknown dataset {name!r}")


def build(name: str, data_dir: str | None = None, **kwargs):
    """``(train, eval)`` datasets of a config's ``dataset`` name."""
    check(name)
    return BUILDERS[name](data_dir, **kwargs)
