"""tpuframe_torch.ops.fused_xent against tpuframe.ops.fused_xent.

The same hidden states, head kernel, labels and loss cotangents (numpy,
from a seed) go into both; per-token losses, argmax and the gradients of
the hidden states and of the kernel are compared in f32 (1e-5: the two sum
each chunk's logits and statistics in other orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe.ops import fused_xent as jax_fx  # noqa: E402
from tpuframe_torch.ops import fused_xent as fx  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(v, *, ignored, seed=0, lead=(2, 12), h=16):
    rng = np.random.default_rng(seed)
    hid = rng.standard_normal((*lead, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, lead).astype(np.int32)
    if ignored:
        labels[0, 3:7] = -100
        labels[1, -1] = -100
    g = rng.standard_normal(lead).astype(np.float32)
    return hid, w, labels, g


@pytest.mark.parametrize("v,chunk", [(96, 32), (100, 32), (100, 128)],
                         ids=["V=3 chunks", "V ragged", "one chunk"])
@pytest.mark.parametrize("ignored", [False, True])
def test_loss_argmax_and_grads_match_jax(v, chunk, ignored):
    hid, w, labels, g = _inputs(v, ignored=ignored)
    ign = -100 if ignored else None

    def loss_sum(hid, w):
        loss, arg = jax_fx.fused_softmax_xent_and_argmax(
            hid, w, jnp.asarray(labels), chunk=chunk, ignore_index=ign)
        return jnp.sum(loss * g), (loss, arg)

    (_, (want_loss, want_arg)), (want_dh, want_dw) = jax.value_and_grad(
        loss_sum, argnums=(0, 1), has_aux=True)(jnp.asarray(hid),
                                                jnp.asarray(w))
    th = torch.from_numpy(hid).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss, arg = fx.fused_softmax_xent_and_argmax(
        th, tw, torch.from_numpy(labels), chunk=chunk, ignore_index=ign)
    (loss * torch.from_numpy(g)).sum().backward()
    assert loss.shape == labels.shape and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               **TOL)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(want_arg))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), **TOL)
    if ignored:
        # ignored tokens: zero loss and zero gradient
        assert not loss[0, 3:7].any() and not th.grad[0, 3:7].any()


def test_matches_the_dense_cross_entropy():
    hid, w, labels, _ = _inputs(100, ignored=False, seed=1)
    loss = fx.fused_softmax_xent(torch.from_numpy(hid), torch.from_numpy(w),
                                 torch.from_numpy(labels), chunk=32)
    logits = torch.from_numpy(hid) @ torch.from_numpy(w)
    dense = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 100), torch.from_numpy(labels).long().reshape(-1),
        reduction="none").reshape(labels.shape)
    torch.testing.assert_close(loss, dense, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ignored", [False, True])
def test_mean_xent_and_accuracy_match_jax(ignored):
    hid, w, labels, _ = _inputs(100, ignored=ignored, seed=2)
    # make some predictions right, so accuracy is not trivially 0
    labels[1, :6] = np.argmax(hid[1, :6] @ w, axis=-1)
    ign = -100 if ignored else None

    def mean_loss(hid, w):
        return jax_fx.mean_xent_and_accuracy(hid, w, jnp.asarray(labels),
                                             chunk=32, ignore_index=ign)

    want_loss, want_acc = mean_loss(jnp.asarray(hid), jnp.asarray(w))
    want_dh = jax.grad(lambda h: mean_loss(h, jnp.asarray(w))[0])(
        jnp.asarray(hid))
    th = torch.from_numpy(hid).requires_grad_()
    loss, acc = fx.mean_xent_and_accuracy(th, torch.from_numpy(w),
                                          torch.from_numpy(labels), chunk=32,
                                          ignore_index=ign)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    np.testing.assert_allclose(float(acc), float(want_acc), **TOL)
    assert float(acc) > 0
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), **TOL)


def test_chunked_argmax_matches_jax():
    hid, w, _, _ = _inputs(100, ignored=False, seed=3)
    want = jax_fx.chunked_argmax(jnp.asarray(hid), jnp.asarray(w), chunk=32)
    got = fx.chunked_argmax(torch.from_numpy(hid), torch.from_numpy(w),
                            chunk=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_hidden_products_accumulate_in_f32():
    """bf16 hidden states: both operands rounded to bf16, products summed
    in f32, f32 logits (``preferred_element_type=f32``); the loss matches
    JAX's to the f32 summation order, and gradients come back in bf16."""
    hid, w, labels, g = _inputs(100, ignored=True, seed=4)
    hb = jnp.asarray(hid, jnp.bfloat16)
    want = jax_fx.fused_softmax_xent(hb, jnp.asarray(w), jnp.asarray(labels),
                                     chunk=32, ignore_index=-100)
    th = torch.from_numpy(hid).bfloat16().requires_grad_()
    got = fx.fused_softmax_xent(th, torch.from_numpy(w),
                                torch.from_numpy(labels), chunk=32,
                                ignore_index=-100)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-5)
    (got * torch.from_numpy(g)).sum().backward()
    assert th.grad.dtype == torch.bfloat16
