"""tpuframe_torch's data layer and configs against the JAX package's.

``lm_text``, ``mnist`` and ``cifar10`` must give bit-equal arrays, from
their synthetic generators and from local files in the formats the
reference reads (MNIST idx files, gzipped or not; CIFAR-10's python pickle
batches), the loader the same batches in the same order (two epochs, a
mid-epoch resume, a per-rank split), and the configs the same fields,
defaults, workloads and merge semantics.
"""

import dataclasses
import gzip
import pickle
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpuframe.data import datasets as jax_datasets  # noqa: E402
from tpuframe.data.pipeline import ShardedLoader as JaxLoader  # noqa: E402
from tpuframe.utils import config as jax_config  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.data.pipeline import ShardedLoader  # noqa: E402
from tpuframe_torch.utils import config  # noqa: E402

KW = {"seq_len": 48, "vocab_size": 97, "synthetic_size": 40}


@pytest.mark.parametrize("padded", [False, True])
def test_lm_text_arrays_are_bit_equal(padded):
    got = datasets.lm_text(None, padded_docs=padded, **KW)
    want = jax_datasets.lm_text(None, padded_docs=padded, **KW)
    for g, w in zip(got, want):
        assert set(g.columns) == set(w.columns) == {"input_ids", "labels"}
        for k in g.columns:
            assert g.columns[k].dtype == w.columns[k].dtype
            np.testing.assert_array_equal(g.columns[k], w.columns[k])
    if padded:
        assert (got[0].columns["labels"] == -100).any()


def test_lm_text_reads_a_local_token_stream(tmp_path):
    stream = np.random.default_rng(0).integers(0, 1000, 5000).astype(np.int32)
    np.save(tmp_path / "tokens.npy", stream)
    got = datasets.lm_text(str(tmp_path), seq_len=64, vocab_size=500)
    want = jax_datasets.lm_text(str(tmp_path), seq_len=64, vocab_size=500)
    for g, w in zip(got, want):
        for k in w.columns:
            np.testing.assert_array_equal(g.columns[k], w.columns[k])
    with pytest.raises(NotImplementedError, match="GCS"):
        datasets.lm_text("gs://bucket/lm", seq_len=64)
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.build("svhn")


def _assert_splits_equal(got, want):
    for g, w in zip(got, want):
        assert set(g.columns) == set(w.columns) == {"image", "label"}
        for k in w.columns:
            assert g.columns[k].dtype == w.columns[k].dtype
            np.testing.assert_array_equal(g.columns[k], w.columns[k])


@pytest.mark.parametrize("name,kw", [
    ("mnist", {}),
    ("cifar10", {"keep_u8": False}),
    ("cifar10", {"keep_u8": True}),
])
def test_mnist_and_cifar10_synthetic_splits_are_bit_equal(name, kw):
    got = datasets.build(name, None, synthetic_size=200, **kw)
    want = getattr(jax_datasets, name)(None, synthetic_size=200, **kw)
    _assert_splits_equal(got, want)
    assert len(got[0]) == 200 and len(got[1]) == 64   # max(n // 8, 64)
    image = got[0].columns["image"]
    assert image.shape[1:] == ((28, 28, 1) if name == "mnist"
                               else (32, 32, 3))
    assert image.dtype == (np.uint8 if kw.get("keep_u8") else np.float32)


def _idx(arr: np.ndarray) -> bytes:
    """An idx file: magic 0x0000080N (uint8, rank N), the dims, the data."""
    return (struct.pack(">I", 0x800 | arr.ndim)
            + struct.pack(f">{arr.ndim}I", *arr.shape) + arr.tobytes())


@pytest.mark.parametrize("gzipped", [True, False])
def test_mnist_reads_local_idx_files_like_jax(tmp_path, gzipped):
    rng = np.random.default_rng(2)
    for split, n in (("train", 30), ("t10k", 12)):
        files = {f"{split}-images-idx3-ubyte.gz":
                 rng.integers(0, 256, (n, 28, 28)).astype(np.uint8),
                 f"{split}-labels-idx1-ubyte.gz":
                 rng.integers(0, 10, n).astype(np.uint8)}
        for name, arr in files.items():
            raw = _idx(arr)
            (tmp_path / name).write_bytes(gzip.compress(raw) if gzipped
                                          else raw)
    got = datasets.mnist(str(tmp_path))
    _assert_splits_equal(got, jax_datasets.mnist(str(tmp_path)))
    assert got[0].columns["image"].shape == (30, 28, 28, 1)
    assert got[1].columns["label"].dtype == np.int32
    with pytest.raises(NotImplementedError, match="GCS"):
        datasets.mnist("gs://bucket/mnist")


@pytest.mark.parametrize("keep_u8", [False, True])
def test_cifar10_reads_local_pickle_batches_like_jax(tmp_path, keep_u8):
    rng = np.random.default_rng(3)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (7, 3072)).astype(np.uint8),
                 b"labels": rng.integers(0, 10, 7).tolist(),
                 b"batch_label": name.encode()}
        (tmp_path / name).write_bytes(pickle.dumps(batch))
    got = datasets.cifar10(str(tmp_path), keep_u8=keep_u8)
    _assert_splits_equal(got, jax_datasets.cifar10(str(tmp_path),
                                                   keep_u8=keep_u8))
    assert len(got[0]) == 35 and len(got[1]) == 7
    # rows are CHW: pixel (0, 0)'s channels sit 1024 bytes apart
    first = pickle.loads((tmp_path / "data_batch_1").read_bytes())[b"data"][0]
    if keep_u8:
        np.testing.assert_array_equal(got[0].columns["image"][0, 0, 0],
                                      first[[0, 1024, 2048]])
    with pytest.raises(NotImplementedError, match="GCS"):
        datasets.cifar10("gs://bucket/cifar")


def _jax_batches(loader, it, n):
    return [{k: np.asarray(v) for k, v in next(it).items()}
            for _ in range(n)]


def _port_batches(it, n):
    out = []
    for _ in range(n):
        b = next(it)
        assert all(isinstance(v, torch.Tensor) for v in b.values())
        out.append({k: v.numpy() for k, v in b.items()})
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_loader_two_epochs_and_resume_match_jax():
    train, _ = datasets.lm_text(None, **KW)
    jtrain, _ = jax_datasets.lm_text(None, **KW)
    port = ShardedLoader(train, 8, seed=3)
    ref = JaxLoader(jtrain, 8, None, seed=3)
    assert port.steps_per_epoch() == ref.steps_per_epoch() == 5
    _assert_same(_port_batches(iter(port), 10),
                 _jax_batches(ref, iter(ref), 10))       # two epochs
    _assert_same(_port_batches(port.from_step(7), 6),
                 _jax_batches(ref, ref.from_step(7), 6))  # mid-epoch resume
    # the second epoch is a new permutation, not the first again
    first = _port_batches(port.epoch(0), 5)
    second = _port_batches(port.epoch(1), 5)
    assert any((a["input_ids"] != b["input_ids"]).any()
               for a, b in zip(first, second))
    _assert_same(_port_batches(ShardedLoader(train, 8, shuffle=False)
                               .epoch(0), 5),
                 _jax_batches(None, JaxLoader(jtrain, 8, None,
                                              shuffle=False).epoch(0), 5))


@pytest.mark.parametrize("rank", [0, 1])
def test_per_rank_split_is_the_per_host_split(rank):
    """Rank r of a world of 2 sees what a JAX host r of 2 would: its
    contiguous shard, in the epoch permutation of that shard, half the
    global batch at a time."""
    train, _ = datasets.lm_text(None, **KW)
    jtrain, _ = jax_datasets.lm_text(None, **KW)
    port = ShardedLoader(train, 8, seed=5, world=2, rank=rank)
    ref = JaxLoader(jtrain.shard(2, rank), 4, None, seed=5)
    assert port.host_batch == 4
    _assert_same(_port_batches(port.from_step(3), 8),
                 _jax_batches(ref, ref.from_step(3), 8))
    with pytest.raises(ValueError, match="not divisible"):
        ShardedLoader(train, 9, world=2, rank=0)


def _fields(cls):
    """(name, annotation, default) of every field but ``mesh`` (whose
    MeshSpec classes differ by module; compared by value below)."""
    out = []
    for f in dataclasses.fields(cls):
        if f.name == "mesh":
            continue
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        out.append((f.name, f.type, default))
    return out


def test_config_fields_defaults_and_workloads_match_jax():
    assert _fields(config.TrainConfig) == _fields(jax_config.TrainConfig)
    assert (dataclasses.asdict(config.MeshSpec())
            == dataclasses.asdict(jax_config.MeshSpec()))
    assert list(config.WORKLOADS) == list(jax_config.WORKLOADS)
    for name in config.WORKLOADS:
        got = dataclasses.asdict(config.get_config(name))
        want = dataclasses.asdict(jax_config.get_config(name))
        assert got == want, name


def test_with_overrides_merges_dicts_like_jax():
    sets = [dict(model_kwargs={"remat": False, "seq_mode": None},
                 dataset_kwargs={"seq_len": 4096}, total_steps=3),
            dict(mesh={"data": 1, "seq": 1}, base_lr=1e-4)]
    for kv in sets:
        got = config.get_config("lm_long").with_overrides(**kv)
        want = jax_config.get_config("lm_long").with_overrides(**kv)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = config.get_config("lm_long").with_overrides(**sets[0])
    assert "seq_mode" not in got.model_kwargs          # None deletes
    assert got.model_kwargs["attn_impl"] == "pallas"   # others kept
    assert isinstance(config.get_config("lm_long").with_overrides(
        **sets[1]).mesh, config.MeshSpec)
    with pytest.raises(ValueError, match="unknown config fields"):
        config.get_config("lm_long").with_overrides(nope=1)


def test_mesh_sizes_resolve_against_the_world():
    assert config.MeshSpec(data=-1).sizes(4)["data"] == 4
    assert config.MeshSpec(data=2, seq=-1).sizes(8)["seq"] == 4
    with pytest.raises(ValueError, match="not divisible"):
        config.MeshSpec(data=2, seq=-1).sizes(1)
    with pytest.raises(ValueError, match="needs 8 ranks"):
        config.MeshSpec(data=2, seq=4).sizes(1)
