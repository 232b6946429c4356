"""Kernel-level building blocks outside the op registry.

  fft_conv — FFT convolution (``jnp.fft``), a capability-parity port of the
             reference's FFT conv; not on any default path.
"""
