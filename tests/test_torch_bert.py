"""tpuframe_torch's BERT against the flax BertForSequenceClassification.

The same flax parameters go into both models (``bert_params_from_jax``),
the same token ids, ragged masks and segment ids (numpy, from a seed) into
both forwards, at ``BertConfig.tiny()`` size (4 layers, 128 wide).  The
port runs its ``xla`` attention and its ``pallas`` one (on the CPU, the
flash kernels' plain versions); the JAX model runs its ``xla`` one.

Tolerances.  f32 logits: 1e-5 absolute; the two differ in summation order
only.  f32 gradients of the GLUE loss: 1e-4 relative per tensor.  bf16
logits: 2e-2 absolute, for logits of magnitude ~1: the two round the bf16
activations at different places (flax's GELU, tanh and bias adds run in
bf16 arithmetic, PyTorch's compute in f32 and round once; the matmuls
accumulate in other orders), each a 2^-8 relative step, through four
post-LN layers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe.models import bert as jax_bert  # noqa: E402
from tpuframe.ops import attention as jax_attn  # noqa: E402
from tpuframe.utils import optim as jax_optim  # noqa: E402
from tpuframe_torch.models import bert as torch_bert  # noqa: E402
from tpuframe_torch.models import get_model  # noqa: E402
from tpuframe_torch.models.convert import bert_params_from_jax  # noqa: E402
from tpuframe_torch.models.transformer_lm import _seed_for, dropout  # noqa: E402
from tpuframe_torch.ops import attention as torch_attn  # noqa: E402
from tpuframe_torch.utils.optim import decay_mask  # noqa: E402

B, S = 3, 24


def _jax_model(**kw):
    return jax_bert.BertForSequenceClassification(
        jax_bert.BertConfig.tiny(dropout=0.0, **kw))


@pytest.fixture(scope="module")
def jax_params():
    params = _jax_model(num_classes=3).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _port(params, **kw):
    model = torch_bert.BertForSequenceClassification(
        torch_bert.BertConfig.tiny(dropout=0.0, num_classes=3, **kw),
        device="cpu")
    model.load_state_dict(bert_params_from_jax(params))
    return model


def _batch(pair: bool, seed: int = 0):
    """Ids, a ragged mask (row 0 full) and segment ids (pairs: segment
    B from a random boundary to the row's length)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (B, S), dtype=np.int32)
    lengths = np.array([S] + list(rng.integers(5, S, B - 1)))
    pos = np.arange(S)[None, :]
    mask = (pos < lengths[:, None]).astype(np.int32)
    types = np.zeros_like(ids)
    if pair:
        bounds = rng.integers(2, lengths - 1)
        types = ((pos >= bounds[:, None]) & (pos < lengths[:, None])) \
            .astype(np.int32)
    labels = rng.integers(0, 3, B).astype(np.int32)
    return ids, mask, types, labels


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_f32_logits_match_flax(jax_params, monkeypatch, impl, pair):
    ids, mask, types, _ = _batch(pair)
    want = np.asarray(_jax_model(num_classes=3).apply(
        {"params": jax_params}, ids, mask, types))
    monkeypatch.setenv("TPUFRAME_ATTN_IMPL", impl)
    before = dict(torch_attn.IMPLS)
    with torch.no_grad():
        got = _port(jax_params)(*_t(ids, mask, types))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert torch_attn.IMPLS[impl] - before[impl] == 4   # one per layer


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_glue_loss_grads_match_jax(jax_params, monkeypatch, impl):
    ids, mask, types, labels = _batch(True, seed=1)
    model = _jax_model(num_classes=3)

    def loss_fn(p):
        logits = model.apply({"params": p}, ids, mask, types, train=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], -1))

    jloss, jgrads = jax.value_and_grad(loss_fn)(jax_params)
    want = bert_params_from_jax(jax.tree.map(np.asarray, jgrads))
    monkeypatch.setenv("TPUFRAME_ATTN_IMPL", impl)
    port = _port(jax_params)
    logits = port(*_t(ids, mask, types), train=True, dropout_seed=0)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels).long())
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    total = float(torch.stack([w.norm() for w in want.values()]).norm())
    for name, p in port.named_parameters():
        w = want[name]
        err = float((p.grad - w).norm())
        if name.endswith("key.bias"):
            # Zero by symmetry: the key bias adds q.b to every score of a
            # row, which the softmax cancels; both sides are rounding.
            assert max(err, float(w.norm())) < 1e-6 * total, (name, err)
        else:
            assert err < 1e-4 * float(w.norm()), (name, err / w.norm())


def test_bf16_logits_close_to_flax(jax_params):
    ids, mask, types, _ = _batch(True, seed=2)
    want = np.asarray(_jax_model(num_classes=3, dtype="bfloat16").apply(
        {"params": jax_params}, ids, mask, types))
    with torch.no_grad():
        got = _port(jax_params, dtype="bfloat16")(*_t(ids, mask, types))
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


def test_bert_params_from_jax_maps_every_leaf(jax_params):
    sd = bert_params_from_jax(jax_params)
    model = torch_bert.BertForSequenceClassification(
        torch_bert.BertConfig.tiny(num_classes=3), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)       # strict: every key, every shape
    extra = dict(jax_params, stray={"kernel": np.zeros(3)})
    with pytest.raises(ValueError, match="unmapped|leaves"):
        bert_params_from_jax(extra)


def _hf_state_dict(cfg, seed=0):
    """A random HF-named state dict for ``cfg`` (the shapes of
    ``bert-base-uncased``'s ``bert.*`` tensors at these widths)."""
    rng = np.random.default_rng(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size
    shapes = {"embeddings.word_embeddings.weight": (cfg.vocab_size, h),
              "embeddings.position_embeddings.weight": (cfg.max_position, h),
              "embeddings.token_type_embeddings.weight":
                  (cfg.type_vocab_size, h),
              "embeddings.LayerNorm.weight": (h,),
              "embeddings.LayerNorm.bias": (h,),
              "pooler.dense.weight": (h, h), "pooler.dense.bias": (h,)}
    for n in range(cfg.num_layers):
        pre = f"encoder.layer.{n}."
        for name, (o, k) in {"attention.self.query": (h, h),
                             "attention.self.key": (h, h),
                             "attention.self.value": (h, h),
                             "attention.output.dense": (h, h),
                             "intermediate.dense": (i, h),
                             "output.dense": (h, i)}.items():
            shapes[pre + name + ".weight"] = (o, k)
            shapes[pre + name + ".bias"] = (o,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[pre + name + ".weight"] = (h,)
            shapes[pre + name + ".bias"] = (h,)
    return {"bert." + k: rng.normal(0, 0.1, s).astype(np.float32)
            for k, s in shapes.items()}


def test_load_hf_weights_matches_jax(jax_params):
    cfg = jax_bert.BertConfig.tiny(num_classes=3)
    sd = _hf_state_dict(cfg)
    want = bert_params_from_jax(jax.tree.map(
        np.asarray, jax_bert.load_hf_weights(jax_params, sd, cfg)))
    got = torch_bert.load_hf_weights(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        torch_bert.BertConfig.tiny(num_classes=3))
    assert set(got) == set(want) - {"classifier.weight", "classifier.bias"}
    for k, w in got.items():
        assert w.dtype == torch.float32
        assert torch.equal(w, want[k]), k


def test_load_hf_weights_matches_a_transformers_bert():
    """Pooled output and encoder states against a random-init
    ``transformers.BertModel`` built from a config (no download)."""
    transformers = pytest.importorskip("transformers")
    cfg = torch_bert.BertConfig.tiny(dropout=0.0)
    hf_cfg = transformers.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position,
        type_vocab_size=cfg.type_vocab_size, hidden_act="gelu",
        layer_norm_eps=cfg.layer_norm_eps, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()
    sd = {"bert." + k: v for k, v in hf.state_dict().items()}
    port = torch_bert.BertForSequenceClassification(cfg, device="cpu")
    port.load_state_dict(torch_bert.load_hf_weights(sd, cfg), strict=False)
    ids, mask, types, _ = _t(*_batch(True, seed=3))
    with torch.no_grad():
        out = hf(input_ids=ids, attention_mask=mask, token_type_ids=types)
        states, pooled = port.encode(ids, mask, types)
    np.testing.assert_allclose(states.numpy(),
                               out.last_hidden_state.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(),
                               atol=1e-5, rtol=0)


def test_base_param_count_equals_flax():
    jmodel = jax_bert.BertForSequenceClassification(
        jax_bert.BertConfig.base())
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    model = get_model("bert-base", dtype="bfloat16", device="cpu")
    assert model.cfg.dtype == "bfloat16"
    got = sum(p.numel() for p in model.parameters())
    assert got == want
    assert abs(got - 109.48e6) < 1.0e6
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_decay_mask_matches_jax(jax_params):
    jmask = jax_optim._decay_mask(jax_params)
    # The same tree of booleans, carried through the name map.
    as_arrays = jax.tree.map(lambda keep, p: np.full(p.shape, float(keep)),
                             jmask, jax_params)
    want = {k: bool(v.flatten()[0])
            for k, v in bert_params_from_jax(as_arrays).items()}
    got = decay_mask(_port(jax_params))
    assert got == want
    assert not got["encoder.layers.0.attention_ln.bias"]
    assert got["embeddings.word.weight"]


def test_attention_dropout_matches_jax_given_its_keep_mask():
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    rate, key = 0.1, jax.random.key(7)
    want = np.asarray(jax_attn._xla_attention(
        q, k, v, mask=mask, dropout_rate=rate, dropout_rng=key))
    # attention.py draws its keep mask over the probs' [B, N, S, S]
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, (2, 4, 16, 16)))
    got = torch_attn._xla_attention(
        *map(torch.from_numpy, (q, k, v)),
        mask=torch.from_numpy(mask)[:, None, None, :], dropout_rate=rate,
        keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_dropout_keep_rate_scale_and_determinism():
    x = torch.ones(200_000)
    y = dropout(x, 0.1, 5)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 5e-3
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(y, dropout(x, 0.1, 5))
    assert not torch.equal(y, dropout(x, 0.1, 6))


def test_model_dropout_is_seeded_per_site(jax_params, monkeypatch):
    """Training masks depend on the seed alone, and every site of the
    model (embeddings, 4 x {probs, attention out, FFN out}, pooled) draws
    from its own seed."""
    cfg = torch_bert.BertConfig.tiny(num_classes=3)        # dropout 0.1
    model = torch_bert.BertForSequenceClassification(cfg, device="cpu")
    ids, mask, types = _t(*_batch(True)[:3])
    seeds = []
    real_dropout = torch_bert.dropout
    real_mha = torch_attn.multihead_attention

    def rec_dropout(x, rate, seed):
        seeds.append(seed)
        return real_dropout(x, rate, seed)

    def rec_mha(*a, **kw):
        seeds.append(kw["dropout_seed"])
        return real_mha(*a, **kw)

    monkeypatch.setattr(torch_bert, "dropout", rec_dropout)
    monkeypatch.setattr(torch_attn, "multihead_attention", rec_mha)
    with torch.no_grad():
        a = model(ids, mask, types, train=True, dropout_seed=3)
        assert len(seeds) == len(set(seeds)) == 3 * cfg.num_layers + 2
        assert seeds == [_seed_for(3, cfg.num_layers, 0)] + [
            _seed_for(3, i, site) for i in range(cfg.num_layers)
            for site in (0, 1, 2)] + [_seed_for(3, cfg.num_layers, 1)]
        b = model(ids, mask, types, train=True, dropout_seed=3)
        c = model(ids, mask, types, train=True, dropout_seed=4)
        d = model(ids, mask, types)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, d)
    with pytest.raises(ValueError, match="dropout_seed"):
        model(ids, mask, types, train=True)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_dispatch_counts_the_path_taken(monkeypatch, impl):
    """The reference's rule: dropout sends ``pallas`` to the einsum
    (``xla_dropout``); without dropout ``pallas`` takes the kernel."""
    monkeypatch.setenv("TPUFRAME_ATTN_IMPL", impl)
    model = torch_bert.BertForSequenceClassification(
        torch_bert.BertConfig.tiny(), device="cpu")
    ids, mask, types = _t(*_batch(False)[:3])
    for train, want in ((True, "xla_dropout"), (False, impl)):
        before = dict(torch_attn.IMPLS)
        with torch.no_grad():
            model(ids, mask, types, train=train, dropout_seed=0)
        ran = {k: torch_attn.IMPLS[k] - before[k] for k in before}
        assert ran == {k: 4 * (k == want) for k in ran}, (train, ran)
    with pytest.raises(ValueError, match="dropout_seed"):
        torch_attn.multihead_attention(
            *(torch.zeros(1, 4, 2, 16) for _ in range(3)), dropout_rate=0.1)
