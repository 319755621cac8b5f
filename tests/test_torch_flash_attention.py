"""tpuframe_torch.ops.flash_attention against the JAX flash kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_flash_attention.py
does.  Inputs are drawn with numpy from a seed and handed to both.  The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpuframe.ops import attention as jax_attention  # noqa: E402
from tpuframe.ops import flash_attention as jax_fa  # noqa: E402
from tpuframe_torch.ops import flash_attention as fa  # noqa: E402

ATOL = RTOL = 1e-5   # f32 both sides; they differ in summation order only
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [(causal, masked, s, d)
         for causal in (False, True) for masked in (False, True)
         for s in (32, 64) for d in (16, 32)]


def _inputs(s, d, *, masked, b=2, n=4, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        # batch row 0 keeps a ragged prefix; row 1 is fully masked
        mask = np.zeros((b, s), np.int32)
        mask[0, : (3 * s) // 4] = 1
    return q, k, v, mask


def _both(arrays):
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("causal,masked,s,d", CASES)
def test_flash_mha_lse_matches_jax(causal, masked, s, d):
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(_inputs(s, d, masked=masked))
    want_out, want_lse = jax_fa.flash_mha_lse(jq, jk, jv, mask=jm,
                                              causal=causal, interpret=True)
    got_out, got_lse = fa.flash_mha_lse(tq, tk, tv, mask=tm, causal=causal)
    assert got_out.shape == (2, s, 4, d) and got_lse.shape == (2, 4, s)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=RTOL)
    if masked:  # the fully masked row: zero output, lse = NEG_INF
        assert not got_out[1].any()
        assert (got_lse[1] == fa.NEG_INF).all()


@pytest.mark.parametrize("causal,masked,s,d", CASES)
def test_flash_mha_matches_jax(causal, masked, s, d):
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(
        _inputs(s, d, masked=masked, seed=1))
    want = jax_fa.flash_mha(jq, jk, jv, mask=jm, causal=causal,
                            interpret=True)
    got = fa.flash_mha(tq, tk, tv, mask=tm, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_matches_jax_xla_path(causal):
    """S = 37 does not tile for the JAX kernel (supported() is False), so
    the JAX side is its einsum path; the port takes any S."""
    q, k, v, _ = _inputs(37, 16, masked=False, seed=2)
    mask = np.ones((2, 37), np.int32)
    mask[1, 29:] = 0
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both((q, k, v, mask))
    assert not jax_fa.supported(jq, jk)
    want = jax_attention.multihead_attention(jq, jk, jv, mask=jm,
                                             causal=causal, impl="xla")
    got = fa.flash_mha(tq, tk, tv, mask=tm, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, m = _inputs(32, 16, masked=True)
    before = fa.LAUNCHES
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = fa.flash_mha_lse(*args, mask=torch.from_numpy(m), causal=True)
    want = fa.flash_mha_reference(*args, mask=torch.from_numpy(m),
                                  causal=True)
    assert fa.LAUNCHES == before == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_other_devices_and_shapes_raise():
    meta = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_mha(meta, meta, meta)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="do not match"):
        k = torch.zeros((1, 8, 2, 32))
        fa.flash_mha(q, k, k)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_mha(q, q, q, mask=torch.ones((1, 9)))
    # The launch path checks dtype and head_dim before touching the GPU.
    with pytest.raises(TypeError, match="flash kernel takes"):
        fa._launch(q.half(), q.half(), q.half(), None, False)
    q24 = torch.zeros((1, 8, 2, 24))
    with pytest.raises(ValueError, match="head_dim"):
        fa._launch(q24, q24, q24, None, False)


def test_imports_and_runs_without_triton_or_nvcc():
    """PATH holds only the interpreter's directory, so no nvcc is found."""
    code = """
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "triton":
            raise ImportError("refused " + name)
        return None

sys.meta_path.insert(0, Refuse())
import torch
from tpuframe_torch.ops import flash_attention as fa
q = torch.randn(1, 24, 2, 16)
out = fa.flash_mha(q, q, q, causal=True)
assert out.shape == q.shape and fa.LAUNCHES == 0
assert "triton" not in sys.modules
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
