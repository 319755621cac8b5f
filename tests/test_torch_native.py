"""The port's CRC-32C (``tpuframe_torch.native``, built from
``tpuframe_torch/csrc/crc32c.cc``) against the JAX package's
``tpuframe.native.crc32c`` and the port's plain Python twin.

A checksum is exact: every case must be equal, bit for bit.  Buffers are
random bytes from numpy seeds, of lengths 0 to 100,000, at unaligned
starts, and chained through ``seed``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from tpuframe import native as jax_native  # noqa: E402
from tpuframe_torch import _build  # noqa: E402
from tpuframe_torch import native  # noqa: E402

LENGTHS = [0, 1, 7, 8, 9, 63, 64, 65, 1000, 4097, 100_000]


def _buf(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8)


def test_known_vector():
    # the CRC-32C check value (RFC 3720, appendix B.4)
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c_py(b"123456789") == 0xE3069283
    assert native.loaded()


@pytest.mark.parametrize("n", LENGTHS)
def test_equals_the_jax_package_and_the_python_twin(n):
    data = _buf(n, seed=n).tobytes()
    got = native.crc32c(data)
    assert got == jax_native.crc32c(data)
    if n <= 4097:                       # the byte loop is slow past that
        assert got == native.crc32c_py(data)


@pytest.mark.parametrize("offset", range(8))
def test_unaligned_starts(offset):
    raw = _buf(5000, seed=offset)
    view = raw[offset:]                 # a start off the 8-byte word
    want = jax_native.crc32c(view.tobytes())
    assert native.crc32c(view) == want
    assert native.crc32c(memoryview(raw.tobytes())[offset:]) == want
    assert native.crc32c_py(view) == want


@pytest.mark.parametrize("split", [0, 1, 13, 4096, 9999])
def test_chained_seed_equals_one_pass(split):
    data = _buf(10_000, seed=split).tobytes()
    head = native.crc32c(data[:split])
    assert native.crc32c(data[split:], head) == native.crc32c(data)
    assert (jax_native.crc32c(data[split:], head)
            == native.crc32c_py(data[split:], head) == native.crc32c(data))


def test_arrays_of_any_dtype_are_their_bytes():
    x = np.random.default_rng(3).standard_normal((17, 33)).astype(np.float32)
    assert native.crc32c(x) == jax_native.crc32c(x.tobytes())
    assert native.crc32c(x.T) == jax_native.crc32c(
        np.ascontiguousarray(x.T).tobytes())


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises with
    g++'s output."""
    (tmp_path / "broken.cc").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"g\+\+ broken\.cc exited"):
        _build.load_host("broken")
    assert not list((tmp_path / "_build").glob("*.so"))


def test_builds_into_the_port_build_dir():
    native.crc32c(b"x")
    lib = _build._host_target(_build.SRC_DIR / "crc32c.cc")
    assert lib.parent == _build.BUILD_DIR and lib.exists()
