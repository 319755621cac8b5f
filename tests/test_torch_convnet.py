"""tpuframe_torch.models.convnet against the JAX package's flax ConvNet.

A flax init goes into the port through ``models.convert.convnet_from_jax``;
the same numpy batch from a seed goes through both, at the model's full
width (it is tiny).  With ``dropout=0.0`` the training forward is
deterministic.  f32: the two differ in summation order only, so logits and
the loss within 1e-5 and every gradient within 1e-5 of its tensor's norm
(relative L2).  bf16: both round each convolution and Dense output to
bf16, from sums that may be taken in other orders; the logits (magnitude
~0.5, a bf16 step ~2e-3) may then differ by a few bf16 steps: within 1e-2
(on the CPU they agree exactly; bf16 is 3.4e-3 from f32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe.models.convnet import ConvNet as JaxConvNet  # noqa: E402
from tpuframe_torch import models as port_models  # noqa: E402
from tpuframe_torch.models import convnet  # noqa: E402
from tpuframe_torch.models.convert import convnet_from_jax  # noqa: E402

B = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 28, 28, 1)).astype(np.float32)
    return x, rng.integers(0, 10, B)


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def flax_params():
    m = JaxConvNet(dropout=0.0)
    v = m.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))
    # biases away from their zero init, so that their mapping shows
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0, 0.1, a.shape).astype(np.float32)
                      if p[-1].key == "bias" else np.asarray(a)),
        _np(v["params"]))


def _jax_loss_and_grads(params, x, labels, dtype):
    m = JaxConvNet(dropout=0.0, dtype=dtype)

    def loss(p):
        logits = m.apply({"params": p}, jnp.asarray(x), train=True)
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(lp[jnp.arange(B), labels]), logits

    (jl, logits), g = jax.value_and_grad(loss, has_aux=True)(params)
    return float(jl), np.asarray(logits), convnet_from_jax(_np(g))


def _port(params, dtype="float32"):
    model = convnet.ConvNet(dropout=0.0, dtype=dtype, device="cpu")
    model.load_state_dict(convnet_from_jax(params))
    return model


def _port_loss(model, x, labels):
    logits = model(torch.from_numpy(x), train=True)
    loss = -torch.log_softmax(logits, -1)[torch.arange(B),
                                          torch.from_numpy(labels)].mean()
    loss.backward()
    return float(loss.detach()), logits.detach()


def test_f32_logits_loss_and_gradients_match_flax(flax_params):
    x, labels = _batch()
    jl, jlogits, want = _jax_loss_and_grads(flax_params, x, labels,
                                            jnp.float32)
    model = _port(flax_params)
    pl, logits = _port_loss(model, x, labels)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-5, rtol=0)
    assert abs(pl - jl) < 1e-5
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert _rel(p.grad, want[name]) < 1e-5, name
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   jlogits, atol=1e-5, rtol=0)


def test_bf16_logits_match_flax(flax_params):
    x, labels = _batch(2)
    _, jlogits, _ = _jax_loss_and_grads(flax_params, x, labels, jnp.bfloat16)
    model = _port(flax_params, "bfloat16")
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-2, rtol=0)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_shapes_names_and_flatten_order_are_flaxs(flax_params):
    """SAME padding: fc1 takes 14 * 14 * 64 features (VALID would give
    9216), in (H, W, C) order; the parameter count is flax's."""
    sd = convnet_from_jax(flax_params)
    assert tuple(sd["fc1.weight"].shape) == (128, 12544)
    model = port_models.get_model("convnet", device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(flax_params)) == 1625866
    with pytest.raises(ValueError, match="leaves"):
        convnet_from_jax({**flax_params, "extra": {"kernel": np.zeros(1)}})


def test_init_follows_flax_lecun_normal():
    model = port_models.get_model("convnet", device="cpu", seed=3)
    for mod, fan_in in ((model.conv2, 9 * 32), (model.fc1, 12544)):
        std = fan_in ** -0.5
        assert abs(float(mod.weight.detach().std()) / std - 1) < 0.05
        assert float(mod.weight.detach().abs().max()) <= 2 * std / .87962566103423978
        assert not mod.bias.any()
    again = port_models.get_model("convnet", device="cpu", seed=3)
    assert torch.equal(again.fc1.weight, model.fc1.weight)


@pytest.mark.parametrize("p", [0.25, 0.5])
def test_dropout_keeps_one_minus_p_scaled_like_flax(p):
    """Each reference rate keeps a fraction 1 - p of the values (within 5
    binomial sigmas over 200k draws) and scales them by 1 / (1 - p), the
    values flax's nn.Dropout gives; the masks come from the generator."""
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = convnet.dropout(x, p, gen)
    kept = float((y != 0).float().mean())
    assert abs(kept - (1 - p)) < 5 * (p * (1 - p) / x.numel()) ** 0.5
    want = np.unique(np.asarray(fnn.Dropout(p, deterministic=False).apply(
        {}, jnp.ones(1000), rngs={"dropout": jax.random.key(0)})))
    np.testing.assert_array_equal(np.unique(y.numpy()), want)
    assert torch.equal(y, convnet.dropout(x, p,
                                          torch.Generator().manual_seed(0)))
    assert convnet.dropout(x, 0.0, gen) is x


def test_reference_rates_in_training_and_none_in_eval():
    model = port_models.get_model("convnet", device="cpu")
    assert model.rates == (0.25, 0.5)
    assert port_models.get_model("convnet", device="cpu",
                                 dropout=0.1).rates == (0.1, 0.1)
    x = torch.from_numpy(_batch()[0])

    def run(seed):
        return model(x, train=True,
                     generator=torch.Generator().manual_seed(seed))

    with torch.no_grad():
        ev = model(x)
        assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
        assert not torch.equal(run(1), ev)
        assert torch.equal(model(x, generator=torch.Generator()), ev)
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)
