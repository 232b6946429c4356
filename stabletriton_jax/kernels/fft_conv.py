"""FFT convolution (exploratory) — port of the reference's FFT-conv track.

The reference explored Monarch-decomposed FFT convolution as a conv escape
hatch (reference ``src/stabletriton/tests/flash_fft.py`` and
``tests/test_fft_conv.py``, parametrized to 4M sequence lengths with SDXL's
320..2560 channel sizes in mind). XLA's conv (cuDNN on the GPU) already owns
SDXL's 3x3 convs (see ops/reference.conv2d), so — like the reference — this stays an
*exploratory* module: an O(N log N) long-sequence conv built on XLA's native
FFT, useful when kernels grow far beyond 3x3 (long-context 1D operators,
large blur kernels), where direct conv FLOPs explode.
"""

from __future__ import annotations

import jax.numpy as jnp


def fft_conv1d(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Causal-free (linear) 1D convolution via FFT.

    x: (..., N); kernel: (K,) with K <= N. Returns the 'same' slice (first N
    samples of the full convolution), fp32.
    """
    n = x.shape[-1]
    k = kernel.shape[-1]
    size = 1
    while size < n + k - 1:
        size *= 2
    xf = jnp.fft.rfft(x.astype(jnp.float32), size)
    kf = jnp.fft.rfft(kernel.astype(jnp.float32), size)
    out = jnp.fft.irfft(xf * kf, size)[..., :n]
    return out


def fft_conv2d(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Depthwise 'same' 2D convolution via FFT.

    x: (B, H, W, C); kernel: (kh, kw) applied per channel (depthwise blur-style
    operator). Odd kernel sizes; zero boundary. fp32.
    """
    b, h, w, c = x.shape
    kh, kw = kernel.shape
    sh, sw = 1, 1
    while sh < h + kh - 1:
        sh *= 2
    while sw < w + kw - 1:
        sw *= 2
    xt = x.astype(jnp.float32).transpose(0, 3, 1, 2)  # (B, C, H, W)
    xf = jnp.fft.rfft2(xt, (sh, sw))
    kf = jnp.fft.rfft2(kernel.astype(jnp.float32), (sh, sw))
    full = jnp.fft.irfft2(xf * kf, (sh, sw))
    oy, ox = kh // 2, kw // 2
    out = full[:, :, oy:oy + h, ox:ox + w]
    return out.transpose(0, 2, 3, 1)
