"""tpuframe_torch.utils.optim against the JAX package's optax chains.

The same flax init goes into both (``params_from_jax``), then the same 50
gradient trees (numpy, from a seed, scaled so that clipping fires on some
steps and not on others).  optax updates the flax tree with
``tpuframe.utils.build_optimizer``; the port updates the model in place.
f32 throughout; the two differ in rounding order only: rtol 1e-6, with an
atol of 1e-7 for entries near zero (a few f32 steps of the weights,
|w| < 0.5, over 50 updates).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tpuframe.models import transformer_lm as jax_lm  # noqa: E402
from tpuframe.utils import optim as jax_optim  # noqa: E402
from tpuframe.utils.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tpuframe_torch.models import transformer_lm as torch_lm  # noqa: E402
from tpuframe_torch.models.convert import params_from_jax  # noqa: E402
from tpuframe_torch.utils import optim  # noqa: E402
from tpuframe_torch.utils.config import TrainConfig  # noqa: E402

STEPS = 50
BASE = dict(name="optim", model="transformer-lm", total_steps=STEPS,
            global_batch=512)
CASES = {
    "adamw-mask-warmup-cosine-clip": dict(
        optimizer="adamw", base_lr=1e-2, scale_lr_by_batch=False,
        warmup_steps=5, schedule="cosine", weight_decay=0.1,
        grad_clip_norm=1.0),
    "sgd-nesterov-decay-scaled-lr": dict(
        optimizer="sgd", base_lr=0.1, warmup_steps=5, schedule="cosine",
        weight_decay=5e-4, momentum=0.9),
    "adamw-linear": dict(optimizer="adamw", base_lr=1e-2,
                         scale_lr_by_batch=False, schedule="linear",
                         weight_decay=0.01),
    "adamw-constant-clip": dict(optimizer="adamw", base_lr=1e-3,
                                scale_lr_by_batch=False, schedule="constant",
                                grad_clip_norm=0.5),
    # optax.lars: the decay and the trust ratio under the decay mask, the
    # momentum on the update after the learning rate
    "lars-decay-warmup-cosine": dict(
        optimizer="lars", base_lr=0.5, warmup_steps=5, schedule="cosine",
        weight_decay=1e-4, momentum=0.9),
    "lars-constant-clip": dict(optimizer="lars", base_lr=2.0,
                               scale_lr_by_batch=False, schedule="constant",
                               grad_clip_norm=1.0, momentum=0.8),
}


@pytest.fixture(scope="module")
def flax_params():
    model = jax_lm.TransformerLM(jax_lm.LMConfig.tiny(vocab_size=64))
    params = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params["params"])


def _grads(params, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        scale = 10 ** rng.uniform(-3.5, -1.5)
        out.append(jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * scale)
            .astype(np.float32), params))
    return out


def _port_model(params):
    lm = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(vocab_size=64),
                                device="cpu")
    lm.load_state_dict(params_from_jax(params))
    return lm


def _fifty_updates(kw, init):
    """50 optax updates and 50 port updates from ``init``: (the optax
    params as a state_dict, the port model, the port's returned norms,
    the gradients)."""
    tx = jax_optim.build_optimizer(JaxTrainConfig(**kw), init)
    state = tx.init(init)
    update = jax.jit(tx.update)
    params = init
    grads = _grads(init)
    for g in grads:
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)

    lm = _port_model(init)
    opt = optim.build_optimizer(TrainConfig(**kw), lm)
    named = dict(lm.named_parameters())
    norms = []
    for g in grads:
        for name, t in params_from_jax(g).items():
            named[name].grad = t
        norms.append(float(opt.step()))
    assert opt.count == STEPS
    want = params_from_jax(jax.tree.map(np.asarray, params))
    for name, t in lm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    return want, lm, norms, grads


@pytest.mark.parametrize("case", list(CASES))
def test_fifty_updates_match_optax(flax_params, case):
    kw = dict(BASE, **CASES[case])
    _, _, norms, grads = _fifty_updates(kw, flax_params)
    # the returned norm is optax's global norm of the raw gradients
    np.testing.assert_allclose(
        norms, [float(optax.global_norm(g)) for g in grads], rtol=1e-6)
    if kw.get("grad_clip_norm"):
        clipped = sum(n > kw["grad_clip_norm"] for n in norms)
        assert 0 < clipped < STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_optax_and_starts_at_zero(case):
    kw = dict(BASE, **CASES[case])
    want = jax_optim.lr_schedule(JaxTrainConfig(**kw), 512 / 256.0)
    got = optim.lr_schedule(TrainConfig(**kw), 512 / 256.0)
    counts = range(STEPS + 10)
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(want(c)) for c in counts], rtol=1e-6,
                               atol=1e-12)
    if kw.get("warmup_steps"):
        # optax reads the schedule at the count before incrementing it:
        # the first update runs at lr 0
        assert got(0) == 0.0 and got(1) > 0.0


def test_clip_is_optax_not_clip_grad_norm(flax_params):
    """optax scales by max/norm; torch's clip_grad_norm_ by
    max/(norm + 1e-6), which differs visibly at small norms."""
    kw = dict(BASE, optimizer="sgd", momentum=0.0, base_lr=1.0,
              scale_lr_by_batch=False, schedule="constant",
              grad_clip_norm=1e-3)
    # zero weights: the step's result is exactly -clip(g), unblurred by
    # the rounding of p + update
    zero = jax.tree.map(np.zeros_like, flax_params)
    g = jax.tree.map(lambda p: np.full(p.shape, 1e-5, np.float32),
                     flax_params)
    assert float(optax.global_norm(g)) > 1e-3 * 1.5
    tx = jax_optim.build_optimizer(JaxTrainConfig(**kw), zero)
    updates, _ = tx.update(g, tx.init(zero), zero)
    want = params_from_jax(jax.tree.map(np.asarray, updates))

    lm = _port_model(zero)
    named = dict(lm.named_parameters())
    grads = params_from_jax(g)
    for name, t in grads.items():
        named[name].grad = t.clone()
    optim.build_optimizer(TrainConfig(**kw), lm).step()
    # rtol 1e-5: the two global norms sum 70k equal squares in other
    # orders, ~1e-6 apart in f32
    for name, t in lm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=0)

    torch_clipped = [t.clone() for t in grads.values()]
    torch.nn.utils.clip_grad_norm_(torch_clipped, 1e-3)
    rel = max(float(((-c) - want[n]).abs().max() / want[n].abs().max())
              for c, n in zip(torch_clipped, grads))
    assert rel > 1e-4


def test_decay_mask_matches_flax_names(flax_params):
    """No decay on norm scales (flax 'scale', the port's LayerNorm
    'weight'); embed and lm_head are decayed."""
    lm = _port_model(flax_params)
    got = optim.decay_mask(lm)
    want = params_from_jax(jax.tree.map(
        lambda m, p: np.full(p.shape, m, np.float32),
        jax_optim._decay_mask(flax_params), flax_params))
    assert got == {k: bool(v.all()) for k, v in want.items()}
    assert got["embed.weight"] and got["lm_head.weight"]
    assert not got["final_ln.weight"] and not got["blocks.0.attn_ln.weight"]


def test_lars_zero_norm_parameter_takes_trust_ratio_one(flax_params):
    """A decayed tensor that starts at 0 has a parameter norm of 0, so
    optax's trust ratio is 1 on the first update (not 0): the tensor moves
    by -lr times its clipped gradient.  Then 50 updates hold to optax as
    above."""
    name = "blocks.0.up.weight"
    init = jax.tree.map(np.copy, flax_params)
    init["block_0"]["up"]["kernel"][...] = 0.0
    kw = dict(BASE, **CASES["lars-constant-clip"])
    lm = _port_model(init)
    opt = optim.build_optimizer(TrainConfig(**kw), lm)
    assert opt.decay[opt.names.index(name)]
    g = params_from_jax(_grads(init)[0])
    for n, p in lm.named_parameters():
        p.grad = g[n]
    norm = float(opt.step())
    torch.testing.assert_close(dict(lm.named_parameters())[name].detach(),
                               -2.0 * g[name] / max(norm, 1.0), rtol=1e-6,
                               atol=0)
    _fifty_updates(kw, init)
