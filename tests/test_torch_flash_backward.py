"""Gradients of tpuframe_torch.ops.flash_attention against the JAX kernels.

On the CPU the port's backward runs the plain versions of its two CUDA
kernels (``flash_bwd_dq_reference`` / ``flash_bwd_dkv_reference``); the JAX
side differentiates its Pallas kernels in interpret mode, as
tests/test_flash_attention.py does.  Inputs and cotangents are drawn with
numpy from a seed and handed to both, in f32.  The CUDA kernels themselves
are held against the plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe.ops import attention as jax_attention  # noqa: E402
from tpuframe.ops import flash_attention as jax_fa  # noqa: E402
from tpuframe_torch.ops import attention as torch_attention  # noqa: E402
from tpuframe_torch.ops import flash_attention as fa  # noqa: E402

ATOL = RTOL = 1e-5   # f32 both sides; they differ in summation order only

# head_dim 64 and 128 are the tensor-core route's on the card
CASES = [(causal, masked, s, d)
         for causal in (False, True) for masked in (False, True)
         for s in (64, 128) for d in (16, 32, 64, 128)]


def _inputs(s, d, *, masked, b=2, n=3, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, s, n, d)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((b, n, s)).astype(np.float32)
    mask = None
    if masked:
        # batch row 0 keeps a ragged prefix; row 1 is fully masked
        mask = np.zeros((b, s), np.int32)
        mask[0, : (3 * s) // 5] = 1
    return q, k, v, do, dlse, mask


def _torch_leaves(q, k, v):
    return [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]


def _jax_mask(mask):
    return None if mask is None else jnp.asarray(mask)


def _torch_mask(mask):
    return None if mask is None else torch.from_numpy(mask)


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal,masked,s,d", CASES)
def test_flash_mha_grads_match_jax(causal, masked, s, d):
    q, k, v, do, _, mask = _inputs(s, d, masked=masked)

    def loss(q, k, v):
        out = jax_fa.flash_mha(q, k, v, mask=_jax_mask(mask), causal=causal,
                               interpret=True)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch_leaves(q, k, v)
    out = fa.flash_mha(tq, tk, tv, mask=_torch_mask(mask), causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _assert_close(got, want)
    if masked:
        # The fully masked batch row gets exact zeros, not exp overflow.
        for g in got:
            assert not g[1].any()


@pytest.mark.parametrize("causal,masked,s,d", CASES)
def test_flash_mha_lse_grads_match_jax(causal, masked, s, d):
    """Cotangents on both outputs: the lse one reaches the kernels only
    through the fold ``delta - dlse``."""
    q, k, v, do, dlse, mask = _inputs(s, d, masked=masked, seed=1)

    def loss(q, k, v):
        out, lse = jax_fa.flash_mha_lse(q, k, v, mask=_jax_mask(mask),
                                        causal=causal, interpret=True)
        # a fully masked row's lse is the constant NEG_INF: no gradient
        return jnp.sum(out * do) + jnp.sum(lse * dlse)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch_leaves(q, k, v)
    out, lse = fa.flash_mha_lse(tq, tk, tv, mask=_torch_mask(mask),
                                causal=causal)
    got = torch.autograd.grad((out, lse), (tq, tk, tv),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    _assert_close(got, want)
    # Without the fold the grads differ: the lse cotangent is not a no-op.
    no_fold = torch.autograd.grad(
        fa.flash_mha_lse(tq, tk, tv, mask=_torch_mask(mask),
                         causal=causal)[0],
        (tq, tk, tv), torch.from_numpy(do))
    assert max(float((a - b).abs().max()) for a, b in zip(got, no_fold)) \
        > 1e-3


def test_lse_cotangent_alone():
    """Only the lse output is used: the backward sees dO = None."""
    q, k, v, _, dlse, _ = _inputs(64, 16, masked=False, seed=2)

    def loss(q, k, v):
        _, lse = jax_fa.flash_mha_lse(q, k, v, causal=True, interpret=True)
        return jnp.sum(lse * dlse)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch_leaves(q, k, v)
    _, lse = fa.flash_mha_lse(tq, tk, tv, causal=True)
    got = torch.autograd.grad(lse, (tq, tk, tv), torch.from_numpy(dlse))
    _assert_close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_grads_match_jax_xla_path(causal):
    """S = 200 does not tile for the JAX kernel, so the JAX side is its
    einsum path; the port's kernel path takes any S."""
    q, k, v, do, _, _ = _inputs(200, 16, masked=False, seed=3)
    mask = np.ones((2, 200), np.int32)
    mask[1, 150:] = 0
    assert not jax_fa.supported(jnp.asarray(q), jnp.asarray(k))

    def loss(q, k, v):
        out = jax_attention.multihead_attention(
            q, k, v, mask=jnp.asarray(mask), causal=causal, impl="xla")
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch_leaves(q, k, v)
    out = torch_attention.multihead_attention(
        tq, tk, tv, mask=torch.from_numpy(mask), causal=causal,
        impl="pallas")
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _assert_close(got, want)


def test_cpu_backward_launches_no_kernel():
    q, k, v, do, _, mask = _inputs(64, 16, masked=True, seed=4)
    before = dict(fa.LAUNCHES)
    tq, tk, tv = _torch_leaves(q, k, v)
    out = fa.flash_mha(tq, tk, tv, mask=_torch_mask(mask), causal=True)
    out.backward(torch.from_numpy(do))
    assert fa.LAUNCHES == before
    assert set(fa.LAUNCHES) == {"flash_fwd", "flash_bwd_delta",
                                "flash_bwd_dq", "flash_bwd_dkv"}
    assert all(n == 0 for n in fa.LAUNCHES.values())


def test_plain_backward_versions_round_operands_like_the_tpu_kernel():
    """In bf16 the plain versions round P to dO's dtype and ds to q's / k's
    before their products; computing those products on unrounded f32
    values gives other results."""
    q, k, v, do, _, _ = _inputs(64, 16, masked=False, seed=5)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out, lse = fa.flash_mha_reference(tq, tk, tv, causal=True)
    delta = (tdo.float() * out.float()).sum(-1).permute(0, 2, 1)
    dq = fa.flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, causal=True)
    dk, dv = fa.flash_bwd_dkv_reference(tq, tk, tv, tdo, lse, delta,
                                        causal=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    p = fa._recompute_p(tq, tk, lse, None, True)
    dv_f32 = torch.einsum("bnqk,bqnd->bknd", p, tdo.float())
    assert torch.equal(dv, torch.einsum(
        "bnqk,bqnd->bknd", p.bfloat16().float(), tdo.float()).bfloat16())
    assert not torch.equal(dv, dv_f32.bfloat16())


def test_delta_pass_is_rowsum_of_do_times_o():
    """In exact arithmetic sum_j p * dp / sum_j p = rowsum(dO * O); a row
    that keeps no key gets 0."""
    q, k, v, do, _, mask = _inputs(64, 32, masked=True, seed=8)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tmask = _torch_mask(mask)
    out, lse = fa.flash_mha_reference(tq, tk, tv, mask=tmask)
    got = fa.flash_bwd_delta(tq, tk, tv, tdo, lse, mask=tmask)
    assert got.dtype == torch.float32 and got.shape == lse.shape
    want = (tdo * out).sum(-1).permute(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert not got[1].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_delta_pass_keeps_small_query_and_key_gradients(dtype):
    """Values that differ little from key to key make dp - delta small
    against dp, so dq and dk are ~1e-2 of dv, as in BERT's upper layers at
    init.  With delta = rowsum(dO * O) from the output rounded to bf16
    (the TPU kernels' input) that rounding is a per-row offset in every ds,
    and dq and dk come out ~20% wrong; the delta pass keeps them at bf16's
    own rounding of the result.  Against f64 softmax attention on the same
    rounded inputs."""
    rng = np.random.default_rng(9)
    b, s, n, d = 2, 64, 2, 64
    q, k, do = (torch.from_numpy(rng.standard_normal((b, s, n, d)))
                .to(dtype) for _ in range(3))
    u = rng.standard_normal((b, 1, n, d))
    v = torch.from_numpy(u + 1e-2 * rng.standard_normal((b, s, n, d))) \
        .to(dtype)
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[1, 40:] = 0
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    scores = torch.einsum("bqnd,bknd->bnqk", q64, k64) * d ** -0.5
    scores = scores.masked_fill(mask[:, None, None, :] == 0, -1e300)
    o64 = torch.einsum("bnqk,bknd->bqnd", scores.softmax(-1), v64)
    want = torch.autograd.grad(o64, (q64, k64, v64), do.double())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_mha(*leaves, mask=mask)
    got = torch.autograd.grad(out, leaves, do)
    _, lse = fa.flash_fwd(q, k, v, mask=mask)
    rowsum = (do.float() * out.detach().float()).sum(-1).permute(0, 2, 1)
    old = fa.flash_bwd(q, k, v, do, lse, rowsum, mask=mask)

    def rel(a, w):
        return float((a.double() - w).norm() / w.norm())

    assert float(want[0].norm() / want[2].norm()) < 0.02   # dq ~1e-2 of dv
    tol = 1e-2 if dtype == torch.bfloat16 else 3e-5
    for g, w in zip(got, want):
        assert rel(g, w) < tol
    if dtype == torch.bfloat16:
        assert rel(old[0], want[0]) > 0.05 and rel(old[1], want[1]) > 0.05


def test_backward_launch_checks_before_the_gpu():
    q = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(TypeError, match="flash kernel takes"):
        fa._launch_bwd("dq", q.half(), q.half(), q.half(), q.half(), lse,
                       lse, None, False)
    with pytest.raises(ValueError, match="dO"):
        fa._launch_bwd("dkv", q, q, q, q[:, :4], lse, lse, None, False)
    with pytest.raises(ValueError, match="lse must be f32"):
        fa._launch_bwd("dq", q, q, q, q, lse.double(), lse, None, False)
    with pytest.raises(ValueError, match="lse must be f32"):
        fa._launch_bwd("delta", q, q, q, q, lse[:, :1], None, None, False)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", fa.DTYPES)
def test_bwd_route_for_every_dtype_and_head_dim(dtype, d):
    want = ("tensor_core" if dtype == torch.bfloat16 and d in (64, 128)
            else "cuda_core")
    assert fa.bwd_route(dtype, d) == want


def test_bwd_route_raises_for_what_no_route_takes():
    with pytest.raises(TypeError, match="flash kernel takes"):
        fa.bwd_route(torch.float16, 64)
    with pytest.raises(ValueError, match="head_dim"):
        fa.bwd_route(torch.bfloat16, 48)


def test_cpu_backward_counts_no_route():
    """A CPU backward at the tensor-core route's dtype and head dim runs
    the plain versions: neither count moves."""
    q, k, v, do, _, mask = _inputs(64, 64, masked=True, seed=7)
    before, routes = dict(fa.LAUNCHES), dict(fa.BWD_ROUTES)
    tq, tk, tv = (t.detach().bfloat16().requires_grad_()
                  for t in _torch_leaves(q, k, v))
    out = fa.flash_mha(tq, tk, tv, mask=_torch_mask(mask), causal=True)
    out.backward(torch.from_numpy(do).bfloat16())
    assert tq.grad.dtype == torch.bfloat16
    assert fa.LAUNCHES == before and fa.BWD_ROUTES == routes
    assert set(fa.BWD_ROUTES) == {"tensor_core", "cuda_core"}


def test_backward_kernel_on_cpu_tensors_raises_before_the_gpu():
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8))
    routes = dict(fa.BWD_ROUTES)
    for which in ("delta", "dq", "dkv"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fa._launch_bwd(which, q, q, q, q, lse, lse, None, True)
    assert fa.BWD_ROUTES == routes


def test_tc_operand_copies_only_what_16_byte_loads_cannot_read():
    t = torch.zeros((2, 16, 3, 64), dtype=torch.bfloat16)
    assert fa._tc_operand(t) is t
    # head-major storage seen through a transpose: strides stay multiples
    # of 8 elements, so the kernel reads it in place
    s = torch.zeros((2, 3, 16, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert fa._tc_operand(s) is s
    # a row stride of 3 * 68 elements, and data 2 bytes off alignment
    for bad in (torch.zeros((2, 16, 3, 68), dtype=torch.bfloat16)[..., :64],
                torch.zeros(2 * 16 * 3 * 64 + 1, dtype=torch.bfloat16)[1:]
                .view(2, 16, 3, 64)):
        got = fa._tc_operand(bad)
        assert got is not bad and torch.equal(got, bad)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
