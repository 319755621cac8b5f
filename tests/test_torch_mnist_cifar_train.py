"""The reference's workloads 1 and 2, ``mnist_single`` and
``cifar10_resnet18``, through tpuframe_torch's harness and the JAX one.

The JAX harness's own pieces (``tpuframe.train.make_loss_fn``,
``build_optimizer``, ``step.make_train_step`` with no mesh) train each
config's model from a flax init for three steps; the port trains the same
weights (``models.convert``) on the same batches through
``tpuframe_torch.train.make_loss_fn`` and its step.  The configs are the
workloads' own, cut in batch and data size only, plus:

  - ``mnist_single``: the ConvNet with ``dropout=0.0`` (the two packages
    draw masks from different generators);
  - ``cifar10_resnet18``: ResNet-18 with the CIFAR stem at full width on
    uint8 synthetic images, ``pad_crop_flip`` on the raw uint8 batch before
    the normalisation, with the flip bits and crop offsets the JAX step
    drew (the port's augmentation applies them); no warmup, so that the
    weights move from the first step.

f32 throughout, and the two differ in summation order only: losses within
1e-5, parameters and running statistics after three steps within 1e-5
absolute (ResNet-18's small BN-bias updates carry up to 1e-3 of relative
rounding noise, so no relative bound is used).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe import models as jax_models  # noqa: E402
from tpuframe import train as jax_train  # noqa: E402
from tpuframe.data import augment as jax_augment  # noqa: E402
from tpuframe.parallel import step as jax_step  # noqa: E402
from tpuframe.utils import optim as jax_optim  # noqa: E402
from tpuframe.utils.config import get_config as jax_get_config  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch import train as port_train  # noqa: E402
from tpuframe_torch.data import augment  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models.convert import (convnet_from_jax,  # noqa: E402
                                           resnet_from_jax)
from tpuframe_torch.parallel import step as port_step  # noqa: E402
from tpuframe_torch.utils.config import get_config  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402

STEPS = 3
CUTS = {
    "mnist_single": dict(global_batch=16, model_kwargs={"dropout": 0.0},
                         dataset_kwargs={"synthetic_size": 64}),
    "cifar10_resnet18": dict(global_batch=8, warmup_steps=0,
                             dataset_kwargs={"synthetic_size": 64}),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg):
    train, _ = datasets.build(cfg.dataset, None, **cfg.dataset_kwargs)
    b = cfg.global_batch
    return [train[np.arange(b * i, b * (i + 1))] for i in range(STEPS)]


def _jax_draws(shape, step):
    """The flip bits and crop offsets ``pad_crop_flip`` draws in the JAX
    harness's step ``step``: its step key is ``fold_in(key(0), step)``,
    split into the augmentation's key and dropout's."""
    aug_rng, _ = jax.random.split(jax.random.fold_in(jax.random.key(0),
                                                     step))
    b, h, w, _ = shape
    r_crop, r_flip = jax.random.split(aug_rng)
    ry, rx = jax.random.split(r_crop)
    draws = {"flip": jax.random.bernoulli(r_flip, 0.5, (b,)),
             "oy": jax.random.randint(ry, (b,), 0, 9),
             "ox": jax.random.randint(rx, (b,), 0, 9)}
    return aug_rng, {k: torch.from_numpy(np.array(v))
                     for k, v in draws.items()}


@pytest.fixture(scope="module", params=list(CUTS))
def runs(request):
    name = request.param
    jcfg = jax_get_config(name).with_overrides(**CUTS[name])
    cfg = get_config(name).with_overrides(**CUTS[name])
    batches = _batches(cfg)
    model = jax_models.get_model(jcfg.model, dtype=jnp.float32,
                                 **jcfg.model_kwargs)
    x0 = jnp.asarray(batches[0]["image"][:2])
    v = _np(model.init(jax.random.key(cfg.seed),
                       jax_train._maybe_normalize(jcfg, x0)))
    stats = v.get("batch_stats")
    tx = jax_optim.build_optimizer(jcfg, v["params"])
    state = jax_step.TrainState.create(
        v["params"], tx,
        model_state={"batch_stats": stats} if stats is not None else None)
    step = jax_step.make_train_step(jax_train.make_loss_fn(jcfg, model), tx,
                                    None, donate=False)
    want = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
        want.append(float(m["loss"]))
    if stats is None:
        init = convnet_from_jax(v["params"])
        final = convnet_from_jax(_np(state.params))
    else:
        init = resnet_from_jax(v["params"], stats)
        final = resnet_from_jax(_np(state.params),
                                _np(state.model_state["batch_stats"]))

    port = port_models.get_model(cfg.model, dtype=cfg.compute_dtype,
                                 device="cpu", **cfg.model_kwargs)
    port.load_state_dict(init)
    pstate = port_step.TrainState(port, build_optimizer(cfg, port))
    train_step = port_step.make_train_step(port_train.make_loss_fn(cfg),
                                           distributed=cfg.distributed)
    real_apply = augment.apply
    augmented = []

    def jax_drawn_apply(mode, images, gen, *, crop_size=None):
        """The port's augmentation on the draws of the JAX step."""
        assert mode == "pad_crop_flip" and images.dtype == torch.uint8
        aug_rng, draws = _jax_draws(images.shape, len(augmented))
        out = augment.apply_draws(mode, images, draws, crop_size=crop_size)
        augmented.append((out, np.asarray(jax_augment.apply(
            mode, jnp.asarray(images.numpy()), aug_rng))))
        return out

    augment.apply = jax_drawn_apply
    try:
        got = [float(train_step(pstate, {k: torch.from_numpy(x)
                                         for k, x in b.items()})["loss"])
               for b in batches]
    finally:
        augment.apply = real_apply
    return name, want, got, final, port.state_dict(), init, augmented


def test_losses_match_the_jax_harness_step_by_step(runs):
    _, want, got, *_ = runs
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_weights_and_running_stats_match_the_jax_harness(runs):
    _, _, _, want, got, init, _ = runs
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    # the steps moved the stem, the head and the first running mean
    for k in {"conv1.weight", "fc1.weight", "fc.weight",
              "bn1.running_mean"} & set(want):
        assert not torch.equal(got[k], init[k]), k


def test_cifar_augments_the_raw_uint8_batch_as_jax_does(runs):
    """pad_crop_flip pads with raw pixel 0 before the normalisation: given
    the JAX step's draws, the port's augmented uint8 batch is the JAX
    one."""
    name, *_, augmented = runs
    if name != "cifar10_resnet18":
        assert augmented == []          # mnist_single has no augmentation
        return
    assert len(augmented) == STEPS
    for got, want in augmented:
        np.testing.assert_array_equal(got.numpy(), want)
    assert any((g.numpy() == 0).any() for g, _ in augmented)
