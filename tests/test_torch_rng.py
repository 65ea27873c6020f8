"""The port's counter-based RNG equals the JAX package's, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu.ops import rng as jrng  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import rng as trng  # noqa: E402

N = 4096


def _words(seed, n=N):
    """Random uint32 words plus the edge words; half have the top bit set."""
    w = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    w = w.astype(np.uint32)
    w[:6] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    return w


def _t(w):
    return torch.from_numpy(w.astype(np.int64))


def _np(x):
    out = x.numpy()
    assert x.dtype in (torch.int64, torch.float32)
    if x.dtype == torch.int64:
        assert out.min() >= 0 and out.max() <= 0xFFFFFFFF
        return out.astype(np.uint32)
    return out


def test_words_cover_top_bit():
    w = _words(0)
    assert (w >= 0x80000000).mean() > 0.4 and (w == 0xFFFFFFFF).any()


def test_fmix32():
    w = _words(1)
    np.testing.assert_array_equal(_np(trng.fmix32(_t(w))), jrng.fmix32(w))


@pytest.mark.parametrize("n_words", [0, 1, 2, 3])
def test_hash_words(n_words):
    seed = 0xDEADBEEF
    ws = [_words(10 + k) for k in range(n_words)]
    ref = jrng.hash_words(seed, *ws)
    got = trng.hash_words(seed, *(_t(w) for w in ws))
    if n_words == 0:  # a pure scalar hash stays a Python int
        assert int(got) == int(ref)
    else:
        np.testing.assert_array_equal(_np(got), ref)


@pytest.mark.parametrize("seed", [0, 3, 0xFFFFFFFF])
def test_ray_base(seed):
    pix, smp = _words(2), _words(3)
    np.testing.assert_array_equal(
        _np(trng.ray_base(seed, _t(pix), _t(smp))),
        jrng.ray_base(seed, pix, smp))


def test_ray_base_tensor_seed():
    """A seed given as a 0-d tensor hashes like the same Python int."""
    pix, smp = _words(4), _words(5)
    got = trng.ray_base(torch.tensor(0xFFFFFFFF), _t(pix), _t(smp))
    np.testing.assert_array_equal(
        _np(got), jrng.ray_base(np.uint32(0xFFFFFFFF), pix, smp))


@pytest.mark.parametrize("purpose", [jrng.P_CAM_JITTER_U, jrng.P_LENS_V,
                                     jrng.P_DIELECTRIC, jrng.P_MEDIUM])
def test_stream_bits_and_uniform(purpose):
    base, salt = _words(6), _words(7)
    np.testing.assert_array_equal(
        _np(trng.stream_bits(_t(base), purpose)),
        jrng.stream_bits(base, purpose))
    np.testing.assert_array_equal(
        _np(trng.stream_bits(_t(base), purpose, _t(salt))),
        jrng.stream_bits(base, purpose, salt))
    u = _np(trng.uniform(_t(base), purpose))
    np.testing.assert_array_equal(u, jrng.uniform(base, purpose))
    assert u.dtype == np.float32 and u.min() >= 0.0 and u.max() < 1.0


def test_bits_to_uniform():
    w = _words(8)
    np.testing.assert_array_equal(_np(trng.bits_to_uniform(_t(w))),
                                  jrng.bits_to_uniform(w))


@pytest.mark.parametrize("bounce", [0, 1, 9, 0xFFFFFFFF])
def test_bounce_base(bounce):
    base = _words(9)
    np.testing.assert_array_equal(
        _np(trng.bounce_base(_t(base), bounce)),
        jrng.bounce_base(base, np.uint32(bounce)))


def test_mul32_matches_uint64_product():
    """The split multiply is exact mod 2**32 for full words."""
    x, y = _words(11), _words(12)
    ref = (x.astype(np.uint64) * y.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(_np(trng._mul32(_t(x), _t(y))),
                                  ref.astype(np.uint32))
