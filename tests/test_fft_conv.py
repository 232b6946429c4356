"""FFT-conv exploratory module tests — parity with direct convolution.

Mirrors the reference's tests/test_fft_conv.py role (fwd parity over sizes),
but against numpy/XLA direct convolution rather than an external package.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.kernels.fft_conv import fft_conv1d, fft_conv2d


@pytest.mark.parametrize("n,k", [(64, 5), (256, 33), (1024, 257)])
def test_fft_conv1d_matches_direct(n, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n)).astype(np.float32)
    kern = rng.standard_normal(k).astype(np.float32)
    got = np.asarray(fft_conv1d(jnp.asarray(x), jnp.asarray(kern)))
    ref = np.stack([np.convolve(row, kern)[:n] for row in x])
    np.testing.assert_allclose(got, ref, atol=1e-3 * max(1, k / 32))


def test_fft_conv2d_matches_direct():
    from scipy import signal  # available? fall back to manual if not

    pytest.importorskip("scipy")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 16, 2)).astype(np.float32)
    kern = rng.standard_normal((5, 5)).astype(np.float32)
    got = np.asarray(fft_conv2d(jnp.asarray(x), jnp.asarray(kern)))
    for c in range(2):
        ref = signal.convolve2d(x[0, :, :, c], kern, mode="same")
        np.testing.assert_allclose(got[0, :, :, c], ref, atol=1e-4)


def test_fft_conv2d_identity_kernel():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    kern = np.zeros((3, 3), np.float32)
    kern[1, 1] = 1.0
    got = np.asarray(fft_conv2d(jnp.asarray(x), jnp.asarray(kern)))
    np.testing.assert_allclose(got, x, atol=1e-5)
