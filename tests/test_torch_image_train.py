"""tpuframe_torch's image-training slice against the JAX package's.

Data: the ``imagenet`` builder's synthetic arrays and local shards are
bit-equal to the JAX package's, the loader's host cast to bf16 rounds as
the JAX loader's does, and augmentation gives the same images given the
flip bits and crop offsets that JAX drew.  Loss: label-smoothed
cross-entropy and top-5 accuracy.  Optimizer: the decay mask on a ResNet
in both BN modes.  Step parity: the JAX harness's own pieces
(``tpuframe.train.make_loss_fn``, ``build_optimizer``,
``step.make_train_step``) train a tiny Bottleneck ResNet (7x7 stride-2
stem at 32x32, a stride-2 stage) for two steps of nesterov SGD with weight
decay and label smoothing 0.1; the port trains the same init on the same
batches, in one process and on a 2-rank gloo world against the JAX step
on a data=2 mesh of virtual CPU devices.  f32 throughout: losses within
1e-5, parameters and running statistics within 1e-5 absolute (summation
order only).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe.data import augment as jax_augment  # noqa: E402
from tpuframe.data import datasets as jax_datasets  # noqa: E402
from tpuframe.data.pipeline import ShardedLoader as JaxLoader  # noqa: E402
from tpuframe.models import losses as jax_losses  # noqa: E402
from tpuframe.models import resnet as jax_resnet  # noqa: E402
from tpuframe.ops import native_call  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.parallel import mesh as jax_mesh  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import optim as jax_optim  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import augment  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.data.pipeline import ShardedLoader  # noqa: E402
from tpuframe_torch.models import losses  # noqa: E402
from tpuframe_torch.models import resnet as port_resnet  # noqa: E402
from tpuframe_torch.models.convert import resnet_from_jax  # noqa: E402
from tpuframe_torch.ops import fused_conv_bn as fcb  # noqa: E402
from tpuframe_torch.parallel import step as port_step  # noqa: E402
from tpuframe_torch.utils import optim  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = {"image_size": 32, "synthetic_size": 64, "num_classes": 4}


@pytest.mark.parametrize("keep_u8", [False, True])
def test_imagenet_synthetic_arrays_are_bit_equal(keep_u8):
    kw = dict(image_size=16, synthetic_size=80, num_classes=10,
              keep_u8=keep_u8)
    got = datasets.imagenet(None, **kw)
    want = jax_datasets.imagenet(None, **kw)
    for g, w in zip(got, want):
        assert set(g.columns) == set(w.columns) == {"image", "label"}
        for k in w.columns:
            assert g.columns[k].dtype == w.columns[k].dtype
            np.testing.assert_array_equal(g.columns[k], w.columns[k])
    assert len(got[1]) == 64      # eval: an eighth, at least 64


def test_imagenet_reads_local_shards(tmp_path):
    rng = np.random.default_rng(1)
    for i in range(2):
        np.save(tmp_path / f"images_{i:05d}.npy",
                rng.integers(0, 256, (60, 8, 8, 3)).astype(np.uint8))
        np.save(tmp_path / f"labels_{i:05d}.npy", rng.integers(0, 1000, 60))
    for keep_u8 in (False, True):
        got = datasets.imagenet(str(tmp_path), keep_u8=keep_u8)
        want = jax_datasets.imagenet(str(tmp_path), keep_u8=keep_u8)
        for g, w in zip(got, want):
            for k in w.columns:
                assert g.columns[k].dtype == w.columns[k].dtype
                np.testing.assert_array_equal(g.columns[k], w.columns[k])
    with pytest.raises(NotImplementedError, match="GCS"):
        datasets.imagenet("gs://bucket/imagenet")


def test_loader_casts_images_on_the_host_like_jax():
    train, _ = datasets.imagenet(None, **IMG)
    port = ShardedLoader(train, 8, seed=2, cast_floats=torch.bfloat16)
    ref = JaxLoader(train, 8, None, seed=2, cast_floats=jnp.bfloat16)
    for got, want in zip(port.epoch(0), ref.epoch(0)):
        assert got["image"].dtype == torch.bfloat16
        assert got["label"].dtype == torch.int32
        np.testing.assert_array_equal(
            got["image"].float().numpy(),
            np.asarray(want["image"]).astype(np.float32))
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))


def _jax_draws(mode, shape, rng, crop_size):
    """The flip bits and crop offsets ``tpuframe.data.augment.apply``
    draws from ``rng`` (its own split order)."""
    b, h, w, _ = shape
    r_crop, r_flip = jax.random.split(rng)
    out = {"flip": torch.from_numpy(np.array(
        jax.random.bernoulli(r_flip, 0.5, (b,))))}
    if mode in ("pad_crop_flip", "crop_flip"):
        ch, cw = (h, w) if mode == "pad_crop_flip" else (crop_size, crop_size)
        hh, ww = (h + 8, w + 8) if mode == "pad_crop_flip" else (h, w)
        ry, rx = jax.random.split(r_crop)
        out["oy"] = torch.from_numpy(np.array(
            jax.random.randint(ry, (b,), 0, hh - ch + 1)))
        out["ox"] = torch.from_numpy(np.array(
            jax.random.randint(rx, (b,), 0, ww - cw + 1)))
    return out


@pytest.mark.parametrize("mode", ["none", "flip", "pad_crop_flip",
                                  "crop_flip"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_augment_equals_jax_given_its_draws(mode, dtype):
    rng = np.random.default_rng(3)
    images = (rng.random((16, 12, 10, 3)) * 255).astype(dtype)
    key = jax.random.key(4)
    want = np.asarray(jax_augment.apply(mode, jnp.asarray(images), key,
                                        crop=8))
    draws = _jax_draws(mode, images.shape, key, 8)
    got = augment.apply_draws(mode, torch.from_numpy(images), draws,
                              crop_size=8)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode != "none":
        assert draws["flip"].any() and not draws["flip"].all()


def test_augment_draws_from_the_step_generator():
    images = torch.arange(8 * 6 * 6 * 1, dtype=torch.float32).reshape(
        8, 6, 6, 1)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return augment.apply("pad_crop_flip", images, gen)

    assert torch.equal(run(5), run(5)) and not torch.equal(run(5), run(6))
    np.testing.assert_array_equal(
        augment.center_crop(images, 4).numpy(),
        np.asarray(jax_augment.center_crop(jnp.asarray(images.numpy()), 4)))
    with pytest.raises(ValueError, match="smaller than crop"):
        augment.apply("crop_flip", images, torch.Generator(), crop_size=7)
    with pytest.raises(ValueError, match="unknown augment"):
        augment.apply("cutout", images, torch.Generator())


def test_normalize_u8_matches_the_jax_reference():
    x = np.random.default_rng(5).integers(0, 256, (2, 4, 4, 3)).astype(
        np.uint8)
    for data_dir, mean, std in ((None, 0.0, 1.0),
                                ("/data", jax_datasets.IMAGENET_MEAN,
                                 jax_datasets.IMAGENET_STD)):
        cfg = TrainConfig(name="n", model="resnet50", dataset="imagenet",
                          data_dir=data_dir)
        got = port_train._maybe_normalize(cfg, torch.from_numpy(x))
        want = native_call._jnp_reference(
            jnp.asarray(x), jnp.asarray(mean, jnp.float32),
            jnp.asarray(std, jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    f = torch.rand(2, 4, 4, 3)
    assert port_train._maybe_normalize(cfg, f) is f


def test_smoothed_cross_entropy_and_top5_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, (64, 1000)).astype(np.float32)
    labels = rng.integers(0, 1000, 64).astype(np.int32)
    labels[:8] = np.argsort(logits[:8], -1)[:, -3]   # some top-5 hits
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    for smoothing in (0.0, 0.1):
        np.testing.assert_allclose(
            float(losses.softmax_cross_entropy(tl, tlab, smoothing)),
            float(jax_losses.softmax_cross_entropy(jl, jlab, smoothing)),
            rtol=1e-6)
    got = float(losses.topk_accuracy(tl, tlab, 5))
    assert got == float(jax_losses.topk_accuracy(jl, jlab, 5)) >= 8 / 64


def _tiny_jax(bn):
    return jax_resnet.ResNet(stage_sizes=(1, 1),
                             block_cls=jax_resnet.Bottleneck, num_classes=4,
                             width=8, bn=bn)


def _tiny_port(bn):
    return port_resnet.ResNet((1, 1), port_resnet.Bottleneck, num_classes=4,
                              width=8, bn=bn, device="cpu")


def _init(bn):
    m = _tiny_jax(bn)
    v = m.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=True)
    return m, jax.tree.map(np.asarray, v)


@pytest.mark.parametrize("bn", ["flax", "fused"])
def test_decay_mask_matches_jax(bn):
    """Decayed: conv and Dense kernels.  Not: BN scales and biases, the
    Dense bias; in both BN modes."""
    _, v = _init(bn)
    mask = jax_optim._decay_mask(v["params"])
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, float(m)), mask,
                             v["params"])
    want = resnet_from_jax(as_arrays, v["batch_stats"])
    got = optim.decay_mask(_tiny_port(bn))
    assert got == {k: bool(want[k].all()) for k in got}
    assert got["conv1.weight"] and got["fc.weight"]
    assert not (got["fc.bias"] or got["bn1.weight"]
                or got["layer2.0.downsample.1.bias"])


def _cfg_kwargs(bn):
    return dict(name="img", model="resnet50", model_kwargs={"bn": bn},
                dataset="imagenet", dataset_kwargs=IMG, optimizer="sgd",
                base_lr=0.4, warmup_steps=1, schedule="cosine",
                weight_decay=1e-4, label_smoothing=0.1, global_batch=8,
                total_steps=10, augment="none")


def _batches(n=2):
    train, _ = datasets.imagenet(None, **IMG)
    return [train[np.arange(8 * i, 8 * i + 8)] for i in range(n)]


def _jax_steps(bn, mesh=None):
    """Two JAX harness steps from the tiny init: (losses, state_dict)."""
    model, v = _init(bn)
    jcfg = JaxTrainConfig(**_cfg_kwargs(bn))
    tx = jax_optim.build_optimizer(jcfg, v["params"])
    state = jax_step.TrainState.create(
        v["params"], tx, model_state={"batch_stats": v["batch_stats"]})
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    mesh, donate=False)
    out = []
    for b in _batches():
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        out.append(float(m["loss"]))
    final = resnet_from_jax(jax.tree.map(np.asarray, state.params),
                            jax.tree.map(np.asarray,
                                         state.model_state["batch_stats"]))
    return out, final, resnet_from_jax(v["params"], v["batch_stats"])


def _assert_state_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("bn", ["flax", "fused"])
def test_two_image_steps_match_the_jax_harness(bn):
    want_losses, want, init = _jax_steps(bn)
    cfg = TrainConfig(**_cfg_kwargs(bn))
    model = _tiny_port(bn)
    model.load_state_dict(init)
    state = port_step.TrainState(model, optim.build_optimizer(cfg, model))
    step = port_step.make_train_step(port_train.make_loss_fn(cfg))
    got = [float(step(state, {k: torch.from_numpy(v) for k, v in b.items()})
                 ["loss"]) for b in _batches()]
    np.testing.assert_allclose(got, want_losses, atol=1e-5, rtol=0)
    _assert_state_close(model.state_dict(), want)
    # the step moved the weights and the running statistics
    assert not torch.equal(model.state_dict()["conv1.weight"],
                           init["conv1.weight"])
    assert not torch.equal(model.state_dict()["bn1.running_mean"],
                           init["bn1.running_mean"])


# A worker of the 2-rank gloo run: rank r trains on rows [4r, 4r + 4) of
# each batch; rank 0 writes losses and the state_dict.
_DP_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from tpuframe_torch import train as port_train
from tpuframe_torch.data import datasets
from tpuframe_torch.models import resnet as port_resnet
from tpuframe_torch.parallel import step as port_step
from tpuframe_torch.utils.config import TrainConfig
from tpuframe_torch.utils.optim import build_optimizer

rank, port, out, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
result = {}
for case in json.loads(cases):
    cfg = TrainConfig(**case["cfg"])
    ds, _ = datasets.imagenet(None, **cfg.dataset_kwargs)
    model = port_resnet.ResNet((1, 1), port_resnet.Bottleneck, num_classes=4,
                               width=8, bn=case["bn"], device="cpu")
    model.load_state_dict(torch.load(case["init"]))
    state = port_step.TrainState(model, build_optimizer(cfg, model))
    step = port_step.make_train_step(port_train.make_loss_fn(cfg))
    losses = []
    for i in range(2):
        rows = np.arange(8 * i + 4 * rank, 8 * i + 4 * rank + 4)
        m = step(state, {k: torch.from_numpy(v) for k, v in ds[rows].items()})
        losses.append(float(m["loss"]))
    result[case["bn"]] = {"losses": losses, "state": {
        k: v.tolist() for k, v in model.state_dict().items()}}
if rank == 0:
    with open(out, "w") as f:
        json.dump(result, f)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_steps_match_the_jax_data2_mesh(tmp_path):
    """Each rank normalises with its own half-batch statistics, gradients
    and running statistics are averaged over the world: the JAX step on a
    data=2 mesh does the same with its shard_map replicas.  The JAX oracle
    is the bn="flax" model for both of the port's BN modes (they compute
    the same function from the same weights): the JAX package's fused op
    does not trace under shard_map with jax 0.9.0 (ROADMAP.md queue 3)."""
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=2),
                              devices=jax.devices()[:2])
    losses_, final, init = _jax_steps("flax", mesh)
    path = tmp_path / "init.pt"
    torch.save(init, path)
    cases = [{"bn": bn, "init": str(path), "cfg": _cfg_kwargs(bn)}
             for bn in ("flax", "fused")]
    want = {bn: (losses_, final) for bn in ("flax", "fused")}
    out = tmp_path / "rank0.json"
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER, str(r), port, str(out),
         json.dumps(cases)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    got = json.loads(out.read_text())
    for bn, (losses_, final) in want.items():
        np.testing.assert_allclose(got[bn]["losses"], losses_, atol=1e-5,
                                   rtol=0)
        _assert_state_close(got[bn]["state"], final)


def test_harness_trains_resnet50_fused_on_the_cpu(capsys):
    """imagenet_resnet50 with bn="fused" through ``main`` at full width on
    32x32 synthetic images: finite losses, eval with top-5, and no
    kernel launch (the CPU runs the plain version)."""
    before = fcb.LAUNCHES["fused_conv_bn_bwd"]
    metrics = port_train.main([
        "--config", "imagenet_resnet50", "--device", "cpu",
        "--set", 'model_kwargs={"bn": "fused", "num_classes": 10}',
        "--set", 'dataset_kwargs={"image_size": 32, "synthetic_size": 64, '
                 '"num_classes": 10}',
        "--set", 'mesh={"data": 1}', "--set", "global_batch=8",
        "--set", "total_steps=2", "--set", "eval_every=2",
        "--set", "eval_batches=1", "--set", "log_every=1"])
    out = capsys.readouterr().out
    assert "[tpuframe] imagenet_resnet50: model=resnet50" in out
    assert "[train 2]" in out and "[eval 2]" in out and "top5=" in out
    assert len(metrics["losses"]) == 2
    assert all(np.isfinite(metrics["losses"]))
    assert np.isfinite(metrics["eval_top5"])
    assert fcb.LAUNCHES["fused_conv_bn_bwd"] == before


def test_labels_beyond_the_head_are_refused():
    cfg = port_train.get_config("imagenet_resnet50").with_overrides(
        model_kwargs={"num_classes": 10}, mesh={"data": 1},
        dataset_kwargs={"image_size": 16, "synthetic_size": 64})
    with pytest.raises(ValueError, match="num_classes=10"):
        port_train.build_harness(cfg, device="cpu")
