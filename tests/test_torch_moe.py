"""tpuframe_torch's mixture of experts against the JAX package's.

The same inputs, from numpy seeds, go through ``tpuframe.ops.moe`` and
``tpuframe_torch.ops.moe`` (routing), the flax ``MoEMLP`` and the port's
(with the flax init converted), a tiny MoE ``TransformerLM`` of each on
both attention routes (the JAX flash kernel in interpret mode), and the
port's serving engine against the JAX model's cache path.  Capacities are
tight enough to drop tokens wherever the case says so.

Tolerances.  Routing runs in f32 on both sides: ``dispatch`` is equal
(argmax ties aside, which the random logits do not produce), ``combine``
within 1e-6 (softmax's last bit) and the aux loss within 1e-6.  f32
modules within 1e-5 and the LM's logits within 1e-4 (``test_torch_
transformer_lm.py``'s); bf16: flax's GELU computes in bf16 and the
port's in f32 with one rounding, and the einsums accumulate in other
orders, so the bf16 MoE output is held to its distance from the f32
output (within 2x that, itself below 2e-2 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe.models import transformer_lm as jax_lm  # noqa: E402
from tpuframe.ops import moe as jax_moe  # noqa: E402
from tpuframe_torch.models import transformer_lm as torch_lm  # noqa: E402
from tpuframe_torch.models.convert import params_from_jax  # noqa: E402
from tpuframe_torch.ops import moe as torch_moe  # noqa: E402
from tpuframe_torch.serve.engine import LMEngine  # noqa: E402

LOGIT_ATOL = 1e-4
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_seq=64, moe_experts=4, moe_k=2)


def _logits(t, e, seed):
    return np.random.default_rng(seed).standard_normal((t, e)) \
        .astype(np.float32) * 2.0


@pytest.mark.parametrize("tokens,experts,k,factor", [
    (8, 4, 2, 1.25), (64, 8, 2, 1.0), (8192, 8, 2, 1.25), (7, 3, 1, 0.5),
    (100, 16, 3, 2.0), (1, 64, 1, 1.0), (4096, 8, 2, 1.25)])
def test_capacity_for_matches_jax(tokens, experts, k, factor):
    assert torch_moe.capacity_for(tokens, experts, k, factor) \
        == jax_moe.capacity_for(tokens, experts, k, factor)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("capacity", [64, 8], ids=["ample", "tight"])
def test_route_topk_matches_jax(k, capacity):
    lg = _logits(64, 8, seed=k)
    d, c, a = jax_moe.route_topk(jnp.asarray(lg), k=k, capacity=capacity)
    d2, c2, a2 = torch_moe.route_topk(torch.from_numpy(lg), k=k,
                                      capacity=capacity)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d))
    np.testing.assert_allclose(c2.numpy(), np.asarray(c), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(a2), float(a), atol=1e-6, rtol=0)
    kept = float(np.asarray(d).sum())
    if capacity == 8:
        assert kept < 64 * k          # tokens were dropped
    else:
        assert kept == 64 * k


@pytest.mark.parametrize("k", [1, 2])
def test_offset_routing_of_two_halves_is_the_whole(k):
    """Rows ``[0, 32)`` and ``[32, 64)`` routed each with the counts of
    the half before it and of both halves (``prior``) and the whole
    batch's capacity take the whole batch's slots and weights."""
    lg = torch.from_numpy(_logits(64, 8, seed=10 + k))
    cap = 8
    whole = torch_moe.route(lg, k=k, capacity=cap)
    halves = (lg[:32], lg[32:])
    counts = [torch.stack([m.sum(dim=0) for m in torch_moe.choices(
        torch.softmax(h, dim=-1), k)]) for h in halves]
    total = counts[0] + counts[1]
    parts = [torch_moe.route(halves[0], k=k, capacity=cap,
                             prior=lambda own: (torch.zeros_like(total),
                                                total)),
             torch_moe.route(halves[1], k=k, capacity=cap,
                             prior=lambda own: (counts[0], total))]
    torch.testing.assert_close(torch.cat([p.dispatch() for p in parts]),
                               whole.dispatch(), rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([p.combine() for p in parts]),
                               whole.combine(), rtol=0, atol=0)
    assert float(whole.kept.sum()) < 64 * k
    # the aux loss from the halves' means is the whole's
    me = (parts[0].me + parts[1].me) / 2
    ce = (parts[0].ce + parts[1].ce) / 2
    torch.testing.assert_close(torch_moe.aux_loss(me, ce),
                               torch_moe.aux_loss(whole.me, whole.ce),
                               rtol=0, atol=1e-6)


def _moe_pair(dtype, factor):
    cfg = jax_lm.LMConfig.tiny(**TINY, dtype=dtype,
                               moe_capacity_factor=factor)
    x = np.random.default_rng(3).standard_normal((2, 16, 32)) \
        .astype(np.float32)
    layer = jax_lm.MoEMLP(cfg)
    params = jax.tree.map(np.asarray, layer.init(
        jax.random.key(1), jnp.asarray(x))["params"])
    want, sown = layer.apply({"params": params}, jnp.asarray(x),
                             mutable=["aux_loss"])
    port = torch_lm.MoEMLP(torch_lm.LMConfig.tiny(
        **TINY, dtype=dtype, moe_capacity_factor=factor))
    port.load_state_dict({
        "router.weight": torch.from_numpy(params["router"]["kernel"].T
                                          .copy()),
        "up_experts": torch.from_numpy(params["up_experts"].copy()),
        "down_experts": torch.from_numpy(params["down_experts"].copy())})
    with torch.no_grad():
        got, aux = port(torch.from_numpy(x))
    return (np.asarray(want.astype(jnp.float32)),
            float(jax.tree.leaves(sown)[0]), got.float().numpy(), float(aux))


@pytest.mark.parametrize("factor", [4.0, 0.25], ids=["ample", "tight"])
def test_moe_mlp_f32_matches_flax(factor):
    want, aux_want, got, aux = _moe_pair("float32", factor)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux, aux_want, atol=1e-6, rtol=0)
    if factor == 0.25:
        # some tokens got no expert at all: their rows are zero
        assert (np.abs(want).sum(axis=-1) == 0).any()


def test_moe_mlp_bf16_within_its_distance_from_f32():
    want, _, got, _ = _moe_pair("bfloat16", 0.25)
    f32, _, _, _ = _moe_pair("float32", 0.25)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got, want) <= max(2 * rel(want, f32), 1e-3)
    assert rel(got, f32) < 2e-2


@pytest.fixture(scope="module")
def lm_params():
    model = jax_lm.TransformerLM(jax_lm.LMConfig.tiny(
        **TINY, moe_capacity_factor=0.5))
    return jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _port(params, **kw):
    model = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(**TINY, **kw),
                                   device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model.eval()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_moe_lm_logits_and_aux_match_jax(lm_params, impl):
    ids = np.random.default_rng(5).integers(0, 64, (2, 32), dtype=np.int32)
    cfg = jax_lm.LMConfig.tiny(**TINY, moe_capacity_factor=0.5,
                               attn_impl=impl)
    want, sown = jax_lm.TransformerLM(cfg).apply(
        {"params": lm_params}, jnp.asarray(ids), mutable=["aux_loss"])
    model = _port(lm_params, moe_capacity_factor=0.5, attn_impl=impl)
    aux = []
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), aux_out=aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose([float(a) for a in aux],
                               [float(a) for a in jax.tree.leaves(sown)],
                               atol=1e-6, rtol=0)
    assert isinstance(model.blocks[1].moe, torch_lm.MoEMLP)
    assert not hasattr(model.blocks[0], "moe")


class _JaxCacheLM(fnn.Module):
    """The JAX ``TransformerLM``'s cache path, its blocks chosen as the
    training path chooses them (the JAX model refuses MoE on its cache
    path; its ``Block`` serves an MoE layer there as any other)."""

    cfg: jax_lm.LMConfig

    @fnn.compact
    def __call__(self, ids, kv_cache, cache_length, decode=False):
        c = self.cfg
        positions = (cache_length[:, None] if decode
                     else jnp.arange(ids.shape[-1]))
        x = fnn.Embed(c.vocab_size, c.hidden_size, name="embed")(ids)
        x = x.astype(c.jnp_dtype)
        caches = []
        for i in range(c.num_layers):
            use_moe = c.moe_experts > 0 and (i + 1) % c.moe_every == 0
            x, layer = jax_lm.Block(c, False, use_moe, name=f"block_{i}")(
                x, positions, kv_cache=kv_cache[i],
                cache_length=cache_length, decode=decode)
            caches.append(layer)
        x = fnn.LayerNorm(use_bias=False, name="final_ln")(x)
        logits = fnn.Dense(c.vocab_size, use_bias=False, name="lm_head")(x)
        return logits.astype(jnp.float32), tuple(caches)


def test_engine_prefill_and_decode_logits_match_jax_cache_path(lm_params):
    """Two prompts prefilled into bucket 16 (capacity from the bucket's
    16 tokens: tokens dropped), inserted into two slots, then four decode
    steps over both slots (capacity from 2 tokens)."""
    cfg = torch_lm.LMConfig.tiny(**TINY, moe_capacity_factor=0.5,
                                 attn_impl="pallas")
    engine = LMEngine(cfg, params_from_jax(lm_params), slots=2,
                      max_context=32, prompt_buckets=(16,), decode_block=8,
                      device="cpu")
    seen = []
    engine.model.register_forward_hook(
        lambda m, i, out: seen.append(out[0].float().numpy()))
    jcfg = jax_lm.LMConfig.tiny(**TINY, moe_capacity_factor=0.5,
                                attn_impl="pallas")
    jmodel = _JaxCacheLM(jcfg)
    cap = engine.spec.capacity
    shape = (1, cap, jcfg.num_heads, jcfg.head_dim)
    prompts = [[3, 9, 14, 2, 33, 7, 60, 1, 5, 5, 12], [40, 41, 8, 19, 27]]
    slot_caches, first = [], []
    for slot, p in enumerate(prompts):
        tok, pcache, length = engine.prefill(p)
        engine.insert(slot, pcache, length, tok)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(p)] = p
        jc = tuple((jnp.zeros(shape), jnp.zeros(shape))
                   for _ in range(jcfg.num_layers))
        want, jc = jmodel.apply({"params": lm_params}, jnp.asarray(padded),
                                jc, jnp.zeros((1,), jnp.int32))
        np.testing.assert_allclose(seen[-1], np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
        slot_caches.append(jc)
        first.append(int(np.asarray(want)[0, len(p) - 1].argmax()))
        assert first[-1] == tok
    jcache = tuple((jnp.concatenate([slot_caches[0][i][0],
                                     slot_caches[1][i][0]]),
                    jnp.concatenate([slot_caches[0][i][1],
                                     slot_caches[1][i][1]]))
                   for i in range(jcfg.num_layers))
    lengths = np.array([len(p) for p in prompts], np.int32)
    tokens = np.array(first, np.int32)[:, None]
    for _ in range(4):
        got_tokens = engine.decode_step()
        want, jcache = jmodel.apply({"params": lm_params},
                                    jnp.asarray(tokens), jcache,
                                    jnp.asarray(lengths), decode=True)
        np.testing.assert_allclose(seen[-1], np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
        tokens = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(got_tokens, tokens[:, 0])
        lengths = lengths + 1
