"""Tests that need an NVIDIA GPU (marker ``gpu``): cuDNN attention itself.

On the CPU they skip (decided inside the ``gpu_device`` fixture, never at
import). ``python chip_smoke.py`` runs them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.compile import CompileConfig, compile_unet, resolve_binding
from stabletriton_jax.models.unet import init_unet_params, tiny_unet_config
from stabletriton_jax.ops import gpu, reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX platform is {dev.platform!r}")
    return dev


def _ref(args, op, h):
    with jax.default_matmul_precision("highest"):
        return getattr(reference, op)(*(a.astype(jnp.float32) for a in args),
                                      num_heads=h)


@pytest.mark.parametrize("op,b,h,sq,sk,d", [
    ("attention", 2, 4, 256, 256, 64),
    ("attention", 1, 2, 100, 77, 64),     # odd lengths
    ("attention_qkv", 2, 10, 64, 64, 64),
    ("attention_kv", 2, 20, 64, 77, 64),
    ("attention", 1, 2, 128, 128, 128),
])
def test_cudnn_attention_matches_reference(gpu_device, op, b, h, sq, sk, d):
    rng = np.random.default_rng(0)
    c = h * d
    shapes = {"attention": [(b, sq, c), (b, sk, c), (b, sk, c)],
              "attention_qkv": [(b, sq, 3 * c)],
              "attention_kv": [(b, sq, c), (b, sk, 2 * c)]}[op]
    args = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(jnp.bfloat16)
            for s in shapes]
    fn = jax.jit(lambda *a: getattr(gpu, op)(*a, num_heads=h))
    out = np.asarray(fn(*args), np.float32)
    want = np.asarray(_ref(args, op, h))
    assert np.abs(out - want).max() <= 3e-2 * np.sqrt(np.mean(want ** 2))
    assert "__cudnn$fmha" in fn.lower(*args).compile().as_text()


def test_gpu_binding_unet_close_to_reference(gpu_device):
    cfg = tiny_unet_config()
    assert resolve_binding(CompileConfig())["attention_qkv"] == "cudnn"
    params = init_unet_params(cfg, 0)
    rng = np.random.default_rng(1)
    inputs = (
        jnp.asarray(rng.standard_normal((2, 16, 16, 4), dtype=np.float32)),
        jnp.full((2,), 500.0),
        jnp.asarray(rng.standard_normal((2, 7, cfg.cross_attention_dim), dtype=np.float32)),
        jnp.asarray(rng.standard_normal((2, 16), dtype=np.float32)),
        jnp.zeros((2, 6)),
    )
    with jax.default_matmul_precision("highest"):
        want = compile_unet(cfg, CompileConfig(backend="reference",
                                               dtype="float32"))(params, *inputs)
    got = compile_unet(cfg, CompileConfig(dtype="bfloat16"))(params, *inputs)
    d = np.asarray(got, np.float32) - np.asarray(want)
    assert float(np.mean(d * d)) < 1e-3
