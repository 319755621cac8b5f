"""tpuframe_torch's BertClassifier against the JAX package's.

Both classifiers hold the same flax parameters (``bert_params_from_jax``)
at ``BertConfig.tiny()`` size, f32, buckets 64 and 128, and classify the
same requests of ragged lengths (from a seed) that fill both buckets.
Probabilities within 1e-5: summation order only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tpuframe.models import bert as jax_bert  # noqa: E402
from tpuframe.serve import engine as jax_engine  # noqa: E402
from tpuframe_torch.models import bert as torch_bert  # noqa: E402
from tpuframe_torch.models.convert import bert_params_from_jax  # noqa: E402
from tpuframe_torch.ops import attention as torch_attn  # noqa: E402
from tpuframe_torch.serve.engine import BertClassifier  # noqa: E402


@pytest.fixture(scope="module")
def jax_clf():
    return jax_engine.BertClassifier(
        jax_bert.BertConfig.tiny(num_classes=3), buckets=(64, 128), seed=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_probs_match_jax_over_both_buckets(jax_clf, monkeypatch, impl):
    monkeypatch.setenv("TPUFRAME_ATTN_IMPL", impl)
    clf = BertClassifier(torch_bert.BertConfig.tiny(num_classes=3),
                         bert_params_from_jax(jax.tree.map(np.asarray,
                                                           jax_clf.params)),
                         buckets=(128, 64), device="cpu")
    assert clf.buckets == (64, 128)
    rng = np.random.default_rng(0)
    lengths = [1, 64, 65, 128] + list(rng.integers(2, 129, 4))
    before = dict(torch_attn.IMPLS)
    for n in lengths:
        ids = rng.integers(0, 1024, n)
        label, probs = clf.classify(ids)
        want_label, want = jax_clf.classify(ids)
        assert probs.dtype == np.float32 and probs.shape == (3,)
        np.testing.assert_allclose(probs, want, atol=1e-5, rtol=0)
        assert label == want_label == int(np.argmax(probs))
    assert torch_attn.IMPLS[impl] - before[impl] == 4 * len(lengths)


def test_bucket_limits_and_device_raise(monkeypatch):
    cfg = torch_bert.BertConfig.tiny()                 # max_position 128
    with pytest.raises(ValueError, match="max_position"):
        BertClassifier(cfg, buckets=(64, 256), device="cpu")
    clf = BertClassifier(cfg, buckets=(64,), device="cpu")
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        clf.classify(list(range(65)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        BertClassifier(cfg, device="cuda")
