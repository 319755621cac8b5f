"""Dataset builders (counterpart of ``tpuframe/data/datasets.py``).

Numpy only, a local copy of what the ported slices need: ``ArrayDataset``,
``lm_text``, ``imagenet`` and the four GLUE tasks (``glue_sst2``,
``glue_mnli``, ``glue_stsb``, ``glue_cola``) with their synthetic
generators, which give the same arrays as the JAX package's from the same
arguments.  Rows are gathered with numpy indexing (the JAX package uses
its native C++ gather for the same rows).  ``tokens.npy``, the ImageNet
``.npy`` shards and the GLUE tsv files are read from a local
``data_dir``; ``gs://`` paths and the MNIST and CIFAR-10 builders are not
ported yet (ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

import os
import zlib
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


# ---------------------------------------------------------------------------
# GLUE: SST-2, MNLI, STS-B, CoLA
# ---------------------------------------------------------------------------

def _read_text(data_dir: str, name: str) -> str:
    _local(data_dir)
    with open(os.path.join(data_dir, name), "rb") as f:
        return f.read().decode()


def glue_sst2(data_dir: str | None = None, *, seq_len: int = 128,
              vocab_size: int = 30522, synthetic_size: int = 1024,
              tokenizer=None, vocab_file: str | None = None):
    """Tokenized sentence classification: ``input_ids``,
    ``attention_mask``, ``token_type_ids`` int32 ``[N, S]`` and ``label``
    int32.

    With ``data_dir``: SST-2's ``train.tsv`` / ``dev.tsv``, tokenized by
    a caller's tokenizer (HF-compatible callable), else the WordPiece
    tokenizer when ``vocab_file`` is given or ``<data_dir>/vocab.txt``
    exists, else a crc32 hash of each word (vocab-free).  Without: the
    synthetic batches, bit-equal to the JAX package's."""
    if data_dir is not None:
        tokenizer = _resolve_tokenizer(tokenizer, data_dir, vocab_file)

        def load(name):
            text = _read_text(data_dir, name)
            lines = text.replace("\r\n", "\n").strip().split("\n")[1:]
            sents, labels = [], []
            for line in lines:
                sent, _, lbl = line.rpartition("\t")
                sents.append(sent)
                labels.append(int(lbl))
            return _tokenize(sents, np.asarray(labels, np.int32), seq_len,
                             vocab_size, tokenizer)

        return load("train.tsv"), load("dev.tsv")
    return (_synthetic_tokens(synthetic_size, seq_len, vocab_size, seed=6),
            _synthetic_tokens(max(synthetic_size // 8, 64), seq_len,
                              vocab_size, seed=7))


MNLI_LABELS = {"entailment": 0, "neutral": 1, "contradiction": 2}


def glue_mnli(data_dir: str | None = None, *, seq_len: int = 128,
              vocab_size: int = 30522, synthetic_size: int = 1024,
              tokenizer=None, vocab_file: str | None = None):
    """MNLI sentence-pair classification, 3-way, pair-encoded ``[CLS] a
    [SEP] b [SEP]`` with ``token_type_ids`` 0/1.  With ``data_dir``:
    ``train.tsv`` / ``dev_matched.tsv``, columns found by header name;
    rows whose gold label is ``-`` or missing are dropped."""
    if data_dir is not None:
        tokenizer = _resolve_tokenizer(tokenizer, data_dir, vocab_file)

        def parse_label(raw):
            return MNLI_LABELS.get(raw.strip())

        def load(name):
            pairs, labels = _parse_pair_tsv(
                _read_text(data_dir, name), label_col="gold_label",
                parse_label=parse_label)
            return _tokenize(pairs, np.asarray(labels, np.int32), seq_len,
                             vocab_size, tokenizer)

        return load("train.tsv"), load("dev_matched.tsv")
    return (_synthetic_token_pairs(synthetic_size, seq_len, vocab_size,
                                   seed=8),
            _synthetic_token_pairs(max(synthetic_size // 8, 64), seq_len,
                                   vocab_size, seed=9))


def _parse_pair_tsv(text: str, *, label_col: str, parse_label):
    """A GLUE pair-task tsv with a header: ``((a, b) pairs, labels)``.
    ``parse_label`` maps the raw label to a value, or None to drop the
    row.  Only CRLF is normalised: ``splitlines()`` would also split on
    breaks that may appear inside a text field."""
    lines = text.replace("\r\n", "\n").strip().split("\n")
    col = {c: i for i, c in enumerate(lines[0].split("\t"))}
    ia, ib, il = col["sentence1"], col["sentence2"], col[label_col]
    pairs, labels = [], []
    for line in lines[1:]:
        f = line.split("\t")
        if len(f) <= max(ia, ib, il):
            continue
        lbl = parse_label(f[il])
        if lbl is None:
            continue
        pairs.append((f[ia], f[ib]))
        labels.append(lbl)
    return pairs, labels


def glue_stsb(data_dir: str | None = None, *, seq_len: int = 128,
              vocab_size: int = 30522, synthetic_size: int = 1024,
              tokenizer=None, vocab_file: str | None = None):
    """STS-B sentence-pair regression: ``label`` is an f32 score in
    [0, 5] (the harness trains it with MSE when ``num_classes`` is 1).
    With ``data_dir``: ``train.tsv`` / ``dev.tsv`` with header-located
    ``sentence1`` / ``sentence2`` / ``score``; unscored rows are
    dropped."""
    if data_dir is not None:
        tokenizer = _resolve_tokenizer(tokenizer, data_dir, vocab_file)

        def parse_label(raw):
            try:
                return float(raw)
            except ValueError:
                return None

        def load(name):
            pairs, scores = _parse_pair_tsv(
                _read_text(data_dir, name), label_col="score",
                parse_label=parse_label)
            return _tokenize(pairs, np.asarray(scores, np.float32), seq_len,
                             vocab_size, tokenizer)

        return load("train.tsv"), load("dev.tsv")
    return (_synthetic_score_pairs(synthetic_size, seq_len, vocab_size,
                                   seed=10),
            _synthetic_score_pairs(max(synthetic_size // 8, 64), seq_len,
                                   vocab_size, seed=11))


def glue_cola(data_dir: str | None = None, *, seq_len: int = 128,
              vocab_size: int = 30522, synthetic_size: int = 1024,
              tokenizer=None, vocab_file: str | None = None):
    """CoLA single-sentence acceptability, binary (its metric is the
    Matthews correlation, which the harness derives at eval).  With
    ``data_dir``: ``train.tsv`` / ``dev.tsv`` with no header and four
    columns ``source<TAB>label<TAB>star<TAB>sentence``."""
    if data_dir is not None:
        tokenizer = _resolve_tokenizer(tokenizer, data_dir, vocab_file)

        def load(name):
            text = _read_text(data_dir, name)
            sents, labels = [], []
            for line in text.replace("\r\n", "\n").strip().split("\n"):
                cols = line.split("\t")
                if len(cols) < 4:
                    continue
                labels.append(int(cols[1]))
                sents.append(cols[3])
            return _tokenize(sents, np.asarray(labels, np.int32), seq_len,
                             vocab_size, tokenizer)

        return load("train.tsv"), load("dev.tsv")
    return (_synthetic_tokens(synthetic_size, seq_len, vocab_size, seed=12),
            _synthetic_tokens(max(synthetic_size // 8, 64), seq_len,
                              vocab_size, seed=13))


def _resolve_tokenizer(tokenizer, data_dir, vocab_file):
    """A caller's tokenizer, else WordPiece over an existing vocab, else
    None (the hash fallback of :func:`_tokenize`).  An explicit
    ``vocab_file`` that does not exist raises: hashing instead would only
    show up as bad accuracy."""
    if tokenizer is not None:
        return tokenizer
    vpath = vocab_file or os.path.join(data_dir, "vocab.txt")
    _local(vpath)
    if os.path.exists(vpath):
        from tpuframe_torch.data.wordpiece import WordPieceTokenizer

        return WordPieceTokenizer(vpath)
    if vocab_file is not None:
        raise FileNotFoundError(f"vocab_file not found: {vocab_file}")
    return None


def _tokenize(sents, labels, seq_len, vocab_size, tokenizer):
    """``sents``: strings, or (a, b) pair tuples for two-sentence tasks.
    Without a tokenizer, each whitespace word becomes ``2 + crc32(word) %
    (vocab_size - 4)`` (deterministic across processes, unlike Python's
    salted hash), with ids 101/102 as [CLS]/[SEP] and HF's longest-first
    pair truncation."""
    if tokenizer is not None:
        enc = tokenizer(sents, padding="max_length", truncation=True,
                        max_length=seq_len, return_tensors="np")
        return ArrayDataset({
            "input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
            "token_type_ids": enc.get(
                "token_type_ids",
                np.zeros_like(enc["input_ids"])).astype(np.int32),
            "label": labels,
        })
    ids = np.zeros((len(sents), seq_len), np.int32)
    mask = np.zeros((len(sents), seq_len), np.int32)
    types = np.zeros((len(sents), seq_len), np.int32)

    def hashed(w):
        return 2 + (zlib.crc32(w.encode()) % (vocab_size - 4))

    for i, s in enumerate(sents):
        if isinstance(s, tuple):
            a, b = ([hashed(w) for w in part.split()] for part in s)
            while len(a) + len(b) > seq_len - 3:
                (a if len(a) > len(b) else b).pop()
            toks = [101] + a + [102] + b + [102]
            types[i, len(a) + 2:len(toks)] = 1
        else:
            toks = [101] + [hashed(w) for w in s.split()][: seq_len - 2] \
                + [102]
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return ArrayDataset({"input_ids": ids, "attention_mask": mask,
                         "token_type_ids": types, "label": labels})


def _synthetic_tokens(n, seq_len, vocab_size, *, seed):
    """Single-sentence batches with 2 learnable classes: the token at
    position 1 carries the label; lengths uniform in [S/2, S]."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    ids = rng.integers(4, vocab_size, size=(n, seq_len)).astype(np.int32)
    ids[:, 0] = 101
    ids[:, 1] = 200 + labels
    lengths = rng.integers(seq_len // 2, seq_len + 1, size=n)
    mask = (np.arange(seq_len)[None, :] < lengths[:, None]).astype(np.int32)
    return ArrayDataset({"input_ids": ids, "attention_mask": mask,
                         "token_type_ids": np.zeros_like(ids),
                         "label": labels})


def _synthetic_token_pairs(n, seq_len, vocab_size, *, seed):
    """Pair-encoded batches with 3 learnable classes (the token at
    position 1); segment B starts at a random boundary, so
    ``token_type_ids`` vary."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, size=n).astype(np.int32)
    ids = rng.integers(4, vocab_size, size=(n, seq_len)).astype(np.int32)
    ids[:, 0] = 101
    ids[:, 1] = 200 + labels
    lengths = rng.integers(seq_len // 2, seq_len + 1, size=n)
    bounds = rng.integers(2, np.maximum(lengths - 1, 3))
    pos = np.arange(seq_len)[None, :]
    mask = (pos < lengths[:, None]).astype(np.int32)
    types = ((pos >= bounds[:, None]) & (pos < lengths[:, None])).astype(
        np.int32)
    return ArrayDataset({"input_ids": ids, "attention_mask": mask,
                         "token_type_ids": types, "label": labels})


def _synthetic_score_pairs(n, seq_len, vocab_size, *, seed):
    """Pair-encoded batches with a learnable f32 score: the token at
    position 1 encodes one of 11 levels, scores 0.0-5.0."""
    if vocab_size < 211:  # ids 200..210 must be real embedding rows
        raise ValueError(f"synthetic STS-B needs vocab_size >= 211 for the "
                         f"score signal tokens; got {vocab_size}")
    rng = np.random.default_rng(seed)
    level = rng.integers(0, 11, size=n)
    ds = _synthetic_token_pairs(n, seq_len, vocab_size, seed=seed)
    ds.columns["input_ids"][:, 1] = 200 + level
    ds.columns["label"] = (level / 2.0).astype(np.float32)
    return ds


BUILDERS = {"lm_text": lm_text, "imagenet": imagenet, "glue_sst2": glue_sst2,
            "glue_mnli": glue_mnli, "glue_stsb": glue_stsb,
            "glue_cola": glue_cola}
_LATER = {"mnist": "queue 1, item 4 (the MNIST and CIFAR-10 builders)",
          "cifar10": "queue 1, item 4 (the MNIST and CIFAR-10 builders)"}


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
