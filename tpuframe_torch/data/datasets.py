"""Dataset builders (counterpart of ``tpuframe/data/datasets.py``).

Numpy only, a local copy of what the LM slice needs: ``ArrayDataset`` and
``lm_text`` with its synthetic generators, which give the same arrays as
the JAX package's from the same arguments.  Rows are gathered with numpy
indexing (the JAX package uses its native C++ gather for the same rows).
``tokens.npy`` is read from a local ``data_dir``; ``gs://`` paths and the
image and GLUE builders are not ported yet (ROADMAP.md slices 3 and 4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


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
        if "://" in data_dir:
            raise NotImplementedError(
                f"{data_dir!r}: only local data directories are ported "
                f"(the GCS reader is ROADMAP.md queue 1, item 4)")
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


BUILDERS = {"lm_text": lm_text}


def build(name: str, data_dir: str | None = None, **kwargs):
    """``(train, eval)`` datasets of a config's ``dataset`` name."""
    if name not in BUILDERS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet: the image builders come "
            f"with ResNet training (ROADMAP.md slice 3), the GLUE builders "
            f"with BERT training (slice 4)")
    return BUILDERS[name](data_dir, **kwargs)
