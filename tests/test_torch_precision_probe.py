"""tpuframe_torch.ops.precision_probe against the JAX package's probe.

The JAX probe, ``perf/exp_precision_probe.py``, is loaded from its path
and its Pallas ``kernel`` run through ``pl.pallas_call(...,
interpret=True)`` on the probe's own numpy operands; on the CPU every
precision it names computes in f32, so all three are held to the port's
plain ``"highest"``.  Each plain mode is also held to a float64 product
within the error its precision gives.  The CUDA kernel itself is held
against the plain versions on the card by chip_smoke.py.
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from tpuframe_torch.ops import precision_probe as pp  # noqa: E402

PERF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "perf")

# Plain version vs the JAX probe's kernel, both f32 on the CPU: the same
# rounded products summed in other orders, 256 terms of |x.y| up to ~10.
ATOL = 2e-4

# Max |err| against float64 that each mode's precision gives over the
# probe's 256 x 256 operands: f32 and 3xTF32 keep ~24 and ~22 bits (a few
# 1e-5 over 256 terms), one TF32 pass 11 bits (~1e-2).
F64_BAND = {"highest": (0.0, 1e-4), "high": (0.0, 1e-4),
            "medium": (1e-3, 0.1)}


@pytest.fixture(scope="module")
def jax_probe():
    """The probe module, loaded from its path.  Its ``setup()`` points
    JAX's compilation cache into the repo; that setting is put back."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "exp_precision_probe", os.path.join(PERF, "exp_precision_probe.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        while PERF in sys.path:
            sys.path.remove(PERF)
    return module


def _numpy_inputs():
    """The probe's own draw (``run``): default_rng(0), x then y."""
    rng = np.random.default_rng(0)
    x = np.array(jnp.asarray(rng.normal(size=(256, 256)), jnp.float32))
    y = np.array(jnp.asarray(rng.normal(size=(256, 256)), jnp.float32))
    return x, y


def test_inputs_are_the_probes_draw():
    x, y = _numpy_inputs()
    tx, ty = pp.inputs(seed=0)
    assert np.array_equal(tx.numpy(), x) and np.array_equal(ty.numpy(), y)


@pytest.mark.parametrize("prec", [None, "DEFAULT", "HIGHEST"])
def test_plain_highest_matches_the_jax_probe_kernel(jax_probe, prec):
    x, y = _numpy_inputs()
    precision = None if prec is None else getattr(jax.lax.Precision, prec)
    want = pl.pallas_call(
        functools.partial(jax_probe.kernel, precision),
        out_shape=jax.ShapeDtypeStruct((256, 256), jnp.float32),
        interpret=True)(jnp.asarray(x), jnp.asarray(y))
    got = pp.matmul_reference(torch.from_numpy(x), torch.from_numpy(y),
                              "highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("mode", pp.MODES)
def test_plain_modes_against_float64(mode):
    """Each mode keeps what its precision keeps: the probe's question."""
    err = pp.probe(mode, device="cpu")
    lo, hi = F64_BAND[mode]
    assert lo <= err <= hi, (mode, err)


def test_three_tf32_passes_recover_f32():
    errs = {mode: pp.probe(mode, device="cpu") for mode in pp.MODES}
    assert errs["high"] < errs["medium"] / 100
    assert errs["high"] < 2 * errs["highest"]


def test_round_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10     # tf32's step at 1
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, 1 + ulp / 4,
                      -(1 + ulp / 2), 3.0, 0.0, -0.0])
    want = [1.0, 1 + ulp, 1 + 2 * ulp, 1.0, -(1 + ulp), 3.0, 0.0, -0.0]
    assert pp.round_tf32(x).tolist() == want
    r = pp.round_tf32(torch.randn(1000, generator=torch.Generator()
                                  .manual_seed(0)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("mode", pp.MODES)
def test_ragged_shapes_against_float64(mode):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((70, 45), generator=gen)
    y = torch.randn((45, 130), generator=gen)
    err = float((pp.matmul(x, y, mode).double()
                 - x.double() @ y.double()).abs().max())
    assert err <= (5e-2 if mode == "medium" else 5e-5), (mode, err)


def test_cpu_matmul_runs_the_plain_version_and_launches_nothing():
    x, y = pp.inputs(seed=2, size=64)
    before = dict(pp.LAUNCHES)
    assert torch.equal(pp.matmul(x, y, "high"),
                       pp.matmul_reference(x, y, "high"))
    assert pp.LAUNCHES == before == {"precision_probe": 0}


def test_checks_raise_before_any_gpu():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="mode"):
        pp.matmul(x, x.T, "low")
    with pytest.raises(TypeError, match="f32"):
        pp.matmul(x.double(), x.T.double(), "highest")
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        pp.matmul(x, x, "highest")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            pp.probe("high")
