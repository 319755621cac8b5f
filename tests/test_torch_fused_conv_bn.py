"""tpuframe_torch.ops.fused_conv_bn against the JAX package's fused op.

The same numpy inputs, from a seed, go through
``tpuframe.ops.fused_conv_bn.conv1x1_bn_train`` (its Pallas backward in
interpret mode, as ``tests/test_fused_conv_bn.py`` runs it) and the
port's ``conv1x1_bn_train`` (on the CPU: the kernel's plain version).
y, mean, var and the gradients of a, W, gamma and beta are compared.

Tolerances (the JAX package's own for this op): f32 2e-4, rtol and atol
(the two differ in summation order); bf16 rtol 3e-2 with an atol of 3e-2
x the tensor's largest magnitude (both round at the same places, but
bf16 sums of many rounded products differ in order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuframe.ops import fused_conv_bn as jfcb  # noqa: E402
from tpuframe_torch.models import resnet as port_resnet  # noqa: E402
from tpuframe_torch.ops import fused_conv_bn as fcb  # noqa: E402

EPS = 1e-5


def _inputs(seed, b, h, w, k, c, dtype):
    rng = np.random.default_rng(seed)
    a = rng.normal(1.0, 2.0, (b, h, w, k)).astype(np.float32)
    wk = rng.normal(0.0, 0.2, (k, c)).astype(np.float32)
    gamma = rng.uniform(0.5, 2.0, c).astype(np.float32)
    beta = rng.normal(0.0, 1.0, c).astype(np.float32)
    t = rng.normal(0.0, 1.0, (b, h, w, c)).astype(np.float32)
    if dtype == "bfloat16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a, wk, gamma, beta, t


def _jax_run(a, wk, gamma, beta, t, dtype, block_rows):
    cfg = (EPS, block_rows, True)
    ja = jnp.asarray(a, dtype)

    def loss(a4, w, g, bb):
        y, mean, var = jfcb.conv1x1_bn_train(cfg, a4, w, g, bb)
        return jnp.sum(y.astype(jnp.float32) * t), (y, mean, var)

    (_, (y, mean, var)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
            ja, jnp.asarray(wk), jnp.asarray(gamma), jnp.asarray(beta))
    out = [y, mean, var, *grads]
    return [np.asarray(jnp.asarray(v, jnp.float32)) for v in out]


def _port_run(a, wk, gamma, beta, t, dtype):
    dt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(dt).requires_grad_(),
              *(torch.from_numpy(v).requires_grad_()
                for v in (wk, gamma, beta))]
    y, mean, var = fcb.conv1x1_bn_train(*leaves, eps=EPS)
    (y.float() * torch.from_numpy(t)).sum().backward()
    out = [y, mean, var] + [v.grad for v in leaves]
    return [v.detach().float().numpy() for v in out]


NAMES = ("y", "mean", "var", "da", "dW", "dgamma", "dbeta")


def _assert_close(got, want, dtype):
    for g, w, name in zip(got, want, NAMES):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(
                g, w, rtol=3e-2, atol=3e-2 * max(np.abs(w).max(), 1.0),
                err_msg=name)


# (b, h, w, k, c, JAX block_rows): the JAX package's ragged K=12, C=20;
# a multi-tile case (a 16-row budget gives its Pallas grid 32 steps).
CASES = [(4, 8, 8, 12, 20, 64), (8, 8, 8, 16, 48, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=["ragged", "multi-tile"])
def test_op_matches_jax(case, dtype):
    *shape, block_rows = case
    args = _inputs(0, *shape, dtype)
    want = _jax_run(*args, jnp.dtype(dtype), block_rows)
    got = _port_run(*args, dtype)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stride2_downsample_matches_flax_module(dtype):
    """The port's fused Bottleneck pair with stride 2 (slice, then the op)
    against ``FusedConvBN(strides=2)``: y, every gradient and the updated
    running statistics."""
    rng = np.random.default_rng(3)
    k_in, c_out = 12, 20
    x = rng.normal(0.5, 2.0, (4, 8, 8, k_in)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    mod = jfcb.FusedConvBN(c_out, strides=2, dtype=jdt, interpret=True)
    v = jax.tree.map(np.asarray, mod.init(jax.random.key(0), jnp.asarray(x)))
    v["params"]["scale"] = rng.uniform(0.5, 2.0, c_out).astype(np.float32)
    v["params"]["bias"] = rng.normal(0, 1, c_out).astype(np.float32)
    t = rng.normal(0, 1, (4, 4, 4, c_out)).astype(np.float32)

    def loss(params, xx):
        y, mut = mod.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * t), (y, mut)

    (_, (jy, mut)), (jg, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"],
                                            jnp.asarray(x, jdt))

    dt = getattr(torch, dtype)
    conv = port_resnet.Conv(k_in, c_out, 1, 2, dtype=dt, device="cpu")
    bn = port_resnet.BatchNorm(c_out, dtype=dt, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    y = port_resnet.conv_bn(conv, bn, xt, True, True)
    (y.float() * torch.from_numpy(t)).sum().backward()

    got = [y.detach().float(), xt.grad.float(),
           conv.weight.grad[:, :, 0, 0].T, bn.weight.grad, bn.bias.grad,
           bn.running_mean, bn.running_var]
    want = [jy, jgx, jg["kernel"][0, 0], jg["scale"], jg["bias"],
            mut["batch_stats"]["mean"], mut["batch_stats"]["var"]]
    names = ("y", "da", "dW", "dgamma", "dbeta", "running mean",
             "running var")
    for g, w, name in zip(got, want, names):
        g = g.detach().numpy()
        w = np.asarray(jnp.asarray(w, jnp.float32))
        tol = 2e-4 if dtype == "float32" else 3e-2
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(np.abs(w).max(), 1.0),
                                   err_msg=name)
    assert fcb.LAUNCHES["fused_conv_bn_bwd"] == 0   # the CPU: plain version


def test_eval_mode_matches_flax_module():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 4, 4, 8)).astype(np.float32)
    mod = jfcb.FusedConvBN(16, use_running_average=True, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, mod.init(jax.random.key(1), jnp.asarray(x)))
    mean = rng.normal(0, 1, 16).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    v["batch_stats"] = {"mean": mean, "var": var}
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    w = torch.from_numpy(np.asarray(v["params"]["kernel"])[0, 0])
    got = fcb.conv1x1_bn_eval(
        torch.from_numpy(x), w, torch.from_numpy(v["params"]["scale"]),
        torch.from_numpy(v["params"]["bias"]), torch.from_numpy(mean),
        torch.from_numpy(var), eps=EPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _kernel_operands(seed, m, k, c):
    """Kernel operands as f32 arrays whose values bf16 represents exactly
    (``a [M, K]``, ``w [K, C]``, ``x``, ``dy [M, C]``), and f32 ``coef``
    whose ``g`` mostly is not."""
    rng = np.random.default_rng(seed)
    bf = jnp.bfloat16

    def q(x):   # exactly bf16-representable f32
        return np.array(jnp.asarray(x, bf).astype(jnp.float32))

    a = q(rng.normal(0, 1, (m, k)))
    w = q(rng.normal(0, 0.3, (k, c)))
    x = q(rng.normal(0, 1, (m, c)))
    dy = q(rng.normal(0, 1, (m, c)))
    coef = np.stack([rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c),
                     rng.normal(0, 0.3, c)]).astype(np.float32)
    return a, w, x, dy, coef


def test_plain_version_rounds_g_where_the_tpu_kernel_does():
    """``fused_bwd_reference`` on bf16 operands against the TPU kernel
    itself (``_fused_bwd_matmuls`` in interpret mode), which rounds ``g``
    to bf16 before both products.  The same products without that
    rounding miss the kernel's dW by far more than the tolerance, so the
    test fails if the plain version stops rounding."""
    m, k, c = 64, 16, 24
    a, w, x, dy, coef = _kernel_operands(6, m, k, c)
    hwnc = lambda t: jnp.asarray(t, jnp.bfloat16).reshape(8, 2, 4, -1)  # noqa: E731
    da_t, dw_t = jfcb._fused_bwd_matmuls(
        hwnc(a), jnp.asarray(w, jnp.bfloat16), hwnc(x), hwnc(dy),
        jnp.asarray(coef), block_rows=2048, interpret=True)
    want_da = np.asarray(da_t.astype(jnp.float32)).reshape(m, k)
    want_dw = np.asarray(dw_t)

    bf = torch.bfloat16
    got_da, got_dw = fcb.fused_bwd_reference(
        *(torch.from_numpy(v).to(bf) for v in (a, w, x, dy)),
        torch.from_numpy(coef))
    # f32 sums of exact bf16 products, in another order
    np.testing.assert_allclose(got_dw.numpy(), want_dw, rtol=1e-5,
                               atol=1e-5 * np.abs(want_dw).max())
    np.testing.assert_allclose(got_da.float().numpy(), want_da, rtol=1e-2,
                               atol=1e-2 * np.abs(want_da).max())

    g_f32 = coef[0] * dy - coef[1] * x + coef[2]
    unrounded = a.T @ g_f32
    gap = np.abs(unrounded - want_dw).max() / np.abs(want_dw).max()
    assert gap > 20 * 1e-5


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    a, w, x, dy, coef = (torch.from_numpy(v) for v in
                         _kernel_operands(7, 40, 12, 20))
    before = fcb.LAUNCHES["fused_conv_bn_bwd"]
    da, dw = fcb.fused_bwd(a, w, x, dy, coef)
    ref_da, ref_dw = fcb.fused_bwd_reference(a, w, x, dy, coef)
    assert torch.equal(da, ref_da) and torch.equal(dw, ref_dw)
    assert fcb.LAUNCHES["fused_conv_bn_bwd"] == before
    meta = [t.to("meta") for t in (a, w, x, dy, coef)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fcb.fused_bwd(*meta)
    with pytest.raises(ValueError, match="shapes do not agree"):
        fcb.fused_bwd(a, w[:, :7], x, dy, coef)
    with pytest.raises(ValueError, match="coef"):
        fcb.fused_bwd(a, w, x, dy, coef.double())
    with pytest.raises(ValueError, match="dtypes differ"):
        fcb.fused_bwd(a.bfloat16(), w, x, dy, coef)


@pytest.mark.parametrize("route", ["cuda_core", "tensor_core"])
@pytest.mark.parametrize("m,k,c", [(802816, 64, 256), (12544, 1024, 2048),
                                   (1000, 12, 20), (33, 7, 130), (16, 4, 4),
                                   (17, 4, 4), (802816, 64, 64),
                                   (12544, 2048, 512), (77, 192, 320)])
def test_dw_row_split_covers_every_row_once(m, k, c, route):
    """The dW kernel's split on each route: slices of a multiple of the
    route's row step, none empty, together exactly the M rows; enough
    slices to fill the card when M allows; on the tensor cores no slice
    longer than the accumulation bound."""
    splits, rows = fcb.dw_splits(m, k, c, route)
    tk, tc, step = fcb.dw_tile(route, k, c)
    assert rows % step == 0 and splits >= 1
    assert (splits - 1) * rows < m <= splits * rows
    tiles = -(-k // tk) * -(-c // tc)
    if m >= step * fcb._DW_TARGET_BLOCKS:
        assert splits * tiles >= fcb._DW_TARGET_BLOCKS // 2
    if route == "tensor_core":
        assert rows <= fcb._TC_MAX_SPLIT_ROWS


@pytest.mark.parametrize("k,c,tiles", [(64, 64, (64, 64)),
                                       (128, 256, (128, 128)),
                                       (2048, 512, (128, 128)),
                                       (192, 320, (64, 64))])
def test_dw_tile_follows_the_kernels_tiles(k, c, tiles):
    """dw_tile names the tiles csrc/fused_conv_bn.cu picks: K tiles of 128
    where K allows, C tiles of two warpgroups' 128 channels where C
    allows; rows in steps of 64 on the tensor cores, 16 on the CUDA
    cores."""
    assert fcb.dw_tile("tensor_core", k, c) == (*tiles, 64)
    assert fcb.dw_tile("cuda_core", k, c) == (64, 128, 16)


@pytest.mark.parametrize("dtype", fcb.DTYPES)
@pytest.mark.parametrize("k,c", [(64, 64), (64, 256), (256, 64),
                                 (2048, 512), (192, 320), (12, 20), (7, 130),
                                 (100, 64), (64, 100), (65, 129)])
def test_conv_bn_route_over_dtypes_and_shapes(dtype, k, c):
    """bf16 with K and C multiples of 64 (every ResNet-50 shape) takes the
    tensor cores; f32 and ragged shapes the CUDA cores."""
    aligned = k % 64 == 0 and c % 64 == 0
    want = ("tensor_core" if dtype == torch.bfloat16 and aligned
            else "cuda_core")
    assert fcb.conv_bn_route(dtype, k, c) == want


def test_every_resnet50_shape_takes_the_tensor_cores():
    """The 36 calls of a ResNet-50 step (the port's Bottleneck layout,
    batch 256 at 224): 15 shapes, all on the tensor-core route in bf16."""
    shapes, hw, cin = set(), 56, 64
    for i, n_blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(n_blocks):
            out_hw = hw // (2 if i > 0 and j == 0 else 1)
            shapes |= {(256 * hw * hw, cin, f),
                       (256 * out_hw * out_hw, f, 4 * f)}
            if j == 0:
                shapes.add((256 * out_hw * out_hw, cin, 4 * f))
            cin, hw = 4 * f, out_hw
    assert len(shapes) == 15
    for m, k, c in shapes:
        assert fcb.conv_bn_route(torch.bfloat16, k, c) == "tensor_core"


def test_conv_bn_route_raises_for_what_no_route_takes():
    with pytest.raises(TypeError, match="fused_conv_bn kernel takes"):
        fcb.conv_bn_route(torch.float16, 64, 64)


def test_launch_checks_before_the_gpu_and_counts_no_route():
    """The launch path refuses CPU tensors, and a tensor-core route asked
    for where none exists, before it touches the GPU or a count; a CPU
    backward counts no route."""
    a, w, x, dy, coef = (torch.from_numpy(v) for v in
                         _kernel_operands(8, 64, 64, 64))
    bf = [t.bfloat16() for t in (a, w, x, dy)]
    routes = dict(fcb.ROUTES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fcb._launch(*bf, coef)
    with pytest.raises(ValueError, match="no tensor-core route"):
        fcb._launch(a, w, x, dy, coef, route="tensor_core")
    fcb.fused_bwd(*bf, coef)
    assert fcb.ROUTES == routes
    assert set(fcb.ROUTES) == {"tensor_core", "cuda_core"}
