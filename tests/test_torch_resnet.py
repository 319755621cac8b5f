"""tpuframe_torch.models.resnet against the JAX package's flax ResNet.

A flax init goes into the port through ``models.convert.resnet_from_jax``;
the same numpy batch from a seed goes through both.  The tiny models keep
ResNet-50's traps: the 7x7 stride-2 stem at 32x32 pads (2, 3), the
stride-2 stage's 3x3 pads (0, 1), the max pool pads with -inf, and the
stride-2 downsample slices before its 1x1.  f32 throughout; the two
differ in summation order only: logits and losses within 1e-5, every
gradient within 1e-4 of its tensor's norm (relative L2), running
statistics within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe.models import resnet as jax_resnet  # noqa: E402
from tpuframe.models import torch_import  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch.models import resnet as port_resnet  # noqa: E402
from tpuframe_torch.models.convert import resnet_from_jax  # noqa: E402

# (name, flax block, port block, stages, cifar stem, bn)
TINY = {
    "bottleneck-flax": (jax_resnet.Bottleneck, port_resnet.Bottleneck,
                        (1, 1), False, "flax"),
    "bottleneck-fused": (jax_resnet.Bottleneck, port_resnet.Bottleneck,
                         (1, 1), False, "fused"),
    "basic-cifar-flax": (jax_resnet.BasicBlock, port_resnet.BasicBlock,
                         (1, 1), True, "flax"),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture(scope="module", params=list(TINY))
def tiny_runs(request):
    """One training forward + backward of each tiny model in both
    packages, then an eval forward with the updated running statistics."""
    jblock, pblock, stages, cifar, bn = TINY[request.param]
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 0.3, (4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 4)
    jm = jax_resnet.ResNet(stage_sizes=stages, block_cls=jblock,
                           num_classes=4, width=8, cifar_stem=cifar, bn=bn)
    v = _np(jm.init(jax.random.key(0), jnp.asarray(x), train=True))
    # BN scales away from their init (the last of each block is 0, which
    # would zero its conv's gradient on both sides)
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if p[-1].key == "scale" else a), v["params"])

    def loss(params):
        logits, mut = jm.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(lp[jnp.arange(4), labels]), (logits, mut)

    (jl, (jlogits, mut)), jg = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    jeval = jm.apply({"params": v["params"], **_np(mut)}, jnp.asarray(x))

    model = port_resnet.ResNet(stages, pblock, num_classes=4, width=8,
                               cifar_stem=cifar, bn=bn, device="cpu")
    model.load_state_dict(resnet_from_jax(v["params"], v["batch_stats"]))
    logits = model(torch.from_numpy(x), train=True)
    pl = -torch.log_softmax(logits, -1)[torch.arange(4),
                                        torch.from_numpy(labels)].mean()
    pl.backward()
    with torch.no_grad():
        peval = model(torch.from_numpy(x))
    want = resnet_from_jax(_np(jg), _np(mut["batch_stats"]))
    return {"jax": (float(jl), np.asarray(jlogits), want,
                    np.asarray(jeval)),
            "port": (float(pl), logits.detach().numpy(), model,
                     peval.numpy())}


def test_tiny_resnet_logits_and_loss_match_flax(tiny_runs):
    jl, jlogits, _, jeval = tiny_runs["jax"]
    pl, plogits, _, peval = tiny_runs["port"]
    assert abs(pl - jl) < 1e-5
    np.testing.assert_allclose(plogits, jlogits, atol=1e-5, rtol=0)
    np.testing.assert_allclose(peval, jeval, atol=1e-5, rtol=0)


def test_tiny_resnet_every_gradient_matches_flax(tiny_runs):
    _, _, want, _ = tiny_runs["jax"]
    model = tiny_runs["port"][2]
    named = dict(model.named_parameters())
    assert set(named) | {n for n, _ in model.named_buffers()} == set(want)
    for name, p in named.items():
        assert _rel(p.grad, want[name]) < 1e-4, name


def test_tiny_resnet_running_stats_match_flax(tiny_runs):
    _, _, want, _ = tiny_runs["jax"]
    for name, buf in tiny_runs["port"][2].named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def flax_resnet_tree():
    """A tiny ResNet-50-shaped flax init (two stages, width 8)."""
    m = jax_resnet.ResNet(stage_sizes=(2, 2), block_cls=jax_resnet.Bottleneck,
                          num_classes=5, width=8)
    return _np(m.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)),
                      train=True))


def test_convert_names_and_values_are_torchvisions(flax_resnet_tree):
    """resnet_from_jax of a bn='flax' tree equals the JAX package's own
    torchvision export, name for name and value for value."""
    got = resnet_from_jax(flax_resnet_tree["params"],
                          flax_resnet_tree["batch_stats"])
    want = torch_import.export_torchvision_resnet(flax_resnet_tree)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def _to_fused(block):
    """A bn='flax' Bottleneck's params or stats → the bn='fused' names
    (tests/test_fused_conv_bn.py's mapping)."""
    out = {"FusedConvBN_0": {**block.get("Conv_0", {}),
                             **block["BatchNorm_0"]},
           "Conv_0": block.get("Conv_1"), "BatchNorm_0": block["BatchNorm_1"],
           "FusedConvBN_1": {**block.get("Conv_2", {}),
                             **block["BatchNorm_2"]}}
    if "downsample_bn" in block:
        out["downsample_fused"] = {**block.get("downsample_conv", {}),
                                   **block["downsample_bn"]}
    return {k: v for k, v in out.items() if v is not None}


def test_convert_reads_the_fused_tree_names(flax_resnet_tree):
    """The same weights under bn='fused' names convert to the same
    state_dict, and a fused model takes it."""
    tree = flax_resnet_tree
    params, stats = dict(tree["params"]), dict(tree["batch_stats"])
    for name in [k for k in params if k.startswith("Bottleneck_")]:
        params[name] = _to_fused(params[name])
        stats[name] = _to_fused(stats[name])
    got = resnet_from_jax(params, stats)
    want = resnet_from_jax(tree["params"], tree["batch_stats"])
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    model = port_resnet.ResNet((2, 2), port_resnet.Bottleneck, num_classes=5,
                               width=8, bn="fused", device="cpu")
    model.load_state_dict(got)
    with pytest.raises(ValueError, match="leaves"):
        resnet_from_jax({**params, "extra": {"kernel": np.zeros(1)}}, stats)


@pytest.mark.parametrize("bn", ["flax", "fused"])
def test_resnet50_parameter_shapes_match_flax(bn):
    """Full-width ResNet-50 (25.56 M parameters): every parameter and
    statistic of the port has the shape of the flax init's
    (``jax.eval_shape``), under the same torchvision name."""
    m = jax_resnet.ResNet50(num_classes=1000, bn=bn)
    shapes = jax.eval_shape(lambda: m.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=True))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in
            resnet_from_jax(zeros["params"], zeros["batch_stats"]).items()}
    model = port_models.get_model("resnet50", device="cpu", bn=bn,
                                  num_classes=1000)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(s.shape)) for s in
                           jax.tree.leaves(shapes["params"])) == 25557032


def test_init_follows_flax_initialisers():
    model = port_models.get_model("resnet50", device="cpu", seed=3)
    w = model.layer3[0].conv2.weight                  # [256, 256, 3, 3]
    std = (2.0 / (256 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / .87962566103423978 + 1e-6
    for blk in (model.layer1[0], model.layer4[2]):
        assert not blk.bn3.weight.any() and blk.bn1.weight.eq(1).all()
    assert abs(float(model.fc.weight.std()) - 0.01) < 5e-4
    assert not model.fc.bias.any()
    again = port_models.get_model("resnet50", device="cpu", seed=3)
    assert torch.equal(again.conv1.weight, model.conv1.weight)


@pytest.mark.parametrize("size,k,s,want", [(224, 7, 2, (2, 3)),
                                           (56, 3, 2, (0, 1)),
                                           (32, 7, 2, (2, 3)),
                                           (8, 3, 2, (0, 1)),
                                           (57, 3, 2, (1, 1)),
                                           (56, 3, 1, (1, 1)),
                                           (56, 1, 2, (0, 0))])
def test_same_padding_is_flaxs(size, k, s, want):
    assert port_resnet._same_pads(size, k, s) == want


@pytest.mark.parametrize("kwargs,error,match", [
    ({"bn": "folded"}, NotImplementedError, "item 3"),
    ({"stem": "space_to_depth"}, NotImplementedError, "item 3"),
    ({"remat": True}, NotImplementedError, "item 3"),
    ({"bn": "nope"}, ValueError, "unknown bn"),
])
def test_unported_options_raise(kwargs, error, match):
    with pytest.raises(error, match=match):
        port_models.get_model("resnet50", device="cpu", **kwargs)


def test_fused_basic_block_is_refused_as_in_flax():
    with pytest.raises(ValueError, match="Bottleneck"):
        port_models.get_model("resnet18", device="cpu", bn="fused")
