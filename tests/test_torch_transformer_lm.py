"""tpuframe_torch.models against the flax TransformerLM.

The same flax parameters go into both models (through
``params_from_jax``), the same token ids (numpy, from a seed) into both
forwards, all in f32 at LMConfig.tiny() size.  The JAX flash kernel runs
in interpret mode on the CPU.  The three numerics traps the port must
keep (LayerNorm epsilon, tanh GELU, interleaved RoPE) each have a case
that fails when the trap is sprung.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tpuframe.models import transformer_lm as jax_lm  # noqa: E402
from tpuframe_torch.models import transformer_lm as torch_lm  # noqa: E402
from tpuframe_torch.models.convert import (lm_params_to_jax,  # noqa: E402
                                           params_from_jax)

LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    model = jax_lm.TransformerLM(jax_lm.LMConfig.tiny())
    params = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params["params"])


def _port(cfg, params):
    model = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(**cfg),
                                   device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape,
                                                dtype=np.int32)


def test_params_from_jax_round_trips_every_leaf(jax_params):
    sd = params_from_jax(jax_params)
    model = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)   # strict: every key, every shape

    def back(path, w):          # the inverse of each layout change
        w = w.numpy()
        name = path[-2]
        if name in ("query", "key", "value"):
            return w.T.reshape(64, 4, 16)
        if name == "out":
            return w.T.reshape(4, 16, 64)
        if path[-1] == "kernel":
            return w.T
        return w

    leaves = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    seen = set()
    for path, leaf in leaves:
        keys = tuple(p.key for p in path)
        if keys[0].startswith("block_"):
            i = keys[0].split("_")[1]
            sub = keys[1:-1]
            name = ".".join(("blocks", i) + sub + ("weight",))
        else:
            name = keys[0] + ".weight"
        seen.add(name)
        np.testing.assert_array_equal(back(keys, sd[name]), leaf)
    assert seen == set(sd)


def test_params_from_jax_rejects_other_trees(jax_params):
    extra = dict(jax_params)
    extra["block_0"] = dict(extra["block_0"], adapter={"kernel": np.zeros(
        (64, 4), np.float32)})
    with pytest.raises(ValueError, match="not a TransformerLM tree"):
        params_from_jax(extra)


def test_moe_params_round_trip_through_the_port():
    """An MoE tree (every second block's MLP an ``MoEMLP``) maps leaf for
    leaf: the router kernel transposed, the expert tensors as they are;
    ``lm_params_to_jax`` gives the flax tree back bit for bit."""
    cfg = jax_lm.LMConfig.tiny(moe_experts=4, num_layers=4)
    params = jax.tree.map(np.asarray, jax_lm.TransformerLM(cfg).init(
        jax.random.key(2), jnp.zeros((1, 8), jnp.int32))["params"])
    sd = params_from_jax(params)
    model = torch_lm.TransformerLM(torch_lm.LMConfig.tiny(
        moe_experts=4, num_layers=4), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    moe = params["block_1"]["moe"]
    np.testing.assert_array_equal(sd["blocks.1.moe.router.weight"].numpy(),
                                  moe["router"]["kernel"].T)
    np.testing.assert_array_equal(sd["blocks.3.moe.up_experts"].numpy(),
                                  params["block_3"]["moe"]["up_experts"])
    back = lm_params_to_jax(model.state_dict(), cfg.num_heads)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, want), got in zip(flat, jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, want, err_msg=str(path))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_logits_match_jax(jax_params, impl):
    ids = _ids((2, 32))
    want = jax_lm.TransformerLM(jax_lm.LMConfig.tiny(attn_impl=impl)).apply(
        {"params": jax_params}, jnp.asarray(ids))
    model = _port(dict(attn_impl=impl), jax_params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (2, 32, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


def test_kv_cache_path_matches_jax_through_ring_wraparound(jax_params):
    """Prefill 8 tokens into a capacity-8 ring, then 6 decode steps that
    wrap it (sliding-window attention), logits compared at every step."""
    cfg = jax_lm.LMConfig.tiny(attn_impl="pallas")
    jmodel = jax_lm.TransformerLM(cfg)
    model = _port(dict(attn_impl="pallas"), jax_params)
    ids = _ids((1, 14), seed=3)
    cap = 8
    shape = (1, cap, cfg.num_heads, cfg.head_dim)
    jcache = tuple((jnp.zeros(shape), jnp.zeros(shape))
                   for _ in range(cfg.num_layers))
    tcache = tuple((torch.zeros(shape), torch.zeros(shape))
                   for _ in range(cfg.num_layers))
    want, jcache = jmodel.apply(
        {"params": jax_params}, jnp.asarray(ids[:, :8]), kv_cache=jcache,
        cache_length=jnp.zeros((1,), jnp.int32))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(ids[:, :8]).long(), kv_cache=tcache,
                       cache_length=torch.zeros((1,), dtype=torch.int64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    for t in range(8, 14):
        want, jcache = jmodel.apply(
            {"params": jax_params}, jnp.asarray(ids[:, t:t + 1]),
            kv_cache=jcache, cache_length=jnp.asarray([t], jnp.int32),
            decode=True)
        with torch.no_grad():
            got, _ = model(torch.from_numpy(ids[:, t:t + 1]).long(),
                           kv_cache=tcache,
                           cache_length=torch.tensor([t]), decode=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
    for (jk, jv), (tk, tv) in zip(jcache, tcache):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_layernorm_epsilon_is_flax_1e6():
    """Rows of tiny variance make epsilon dominate: 1e-6 matches flax,
    torch's default 1e-5 does not."""
    import flax.linen as nn

    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 64)) * 1e-3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = np.asarray(nn.LayerNorm(use_bias=False).apply(
        {"params": {"scale": scale}}, jnp.asarray(x)))
    ln = torch_lm.LayerNorm(64)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        got = ln(torch.from_numpy(x)).numpy()
        swapped = F.layer_norm(torch.from_numpy(x), (64,),
                               weight=torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(swapped - want).max() > 1e-2


def test_gelu_is_tanh_approximation(jax_params, monkeypatch):
    """A Block with widened MLP weights matches the flax Block; swapping
    the port's GELU for the exact (erf) one breaks the match."""
    blk = jax.tree.map(np.copy, jax_params["block_0"])
    blk["up"]["kernel"] = blk["up"]["kernel"] * 8.0
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 16, 64)).astype(np.float32)
    cfg = jax_lm.LMConfig.tiny()
    want = np.asarray(jax_lm.Block(cfg).apply(
        {"params": blk}, jnp.asarray(x), jnp.arange(16)))

    sd = params_from_jax({"embed": jax_params["embed"],
                          "final_ln": jax_params["final_ln"],
                          "lm_head": jax_params["lm_head"], "block_0": blk})
    block = torch_lm.Block(torch_lm.LMConfig.tiny())
    block.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()
                           if k.startswith("blocks.0.")})

    def run():
        with torch.no_grad():
            return block(torch.from_numpy(x), torch.arange(16)).numpy()

    np.testing.assert_allclose(run(), want, atol=1e-5, rtol=1e-5)
    exact = F.gelu
    monkeypatch.setattr(torch_lm.F, "gelu",
                        lambda h, approximate="none": exact(h))
    assert np.abs(run() - want).max() > 1e-4


@pytest.mark.parametrize("per_sequence", [False, True])
def test_rope_rotates_interleaved_pairs(per_sequence):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = (np.array([[3], [17]]) if per_sequence else np.arange(5)) \
        .astype(np.int32)
    if per_sequence:
        x = x[:, :1]
    want = np.asarray(jax_lm.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = torch_lm.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    # rotate-half, the other common RoPE layout, would not match
    d = x.shape[-1]
    angles = pos[..., None].astype(np.float32) * 1e4 ** (
        -np.arange(0, d, 2, dtype=np.float32) / d)
    angles = angles if angles.ndim == 3 else angles[None]
    cos, sin = np.cos(angles)[:, :, None], np.sin(angles)[:, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    half = np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    assert np.abs(half - want).max() > 1e-2
