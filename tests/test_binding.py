"""The op binding follows the JAX platform (compile.PLATFORM_BINDINGS)."""

import jax
import pytest

from stabletriton_jax import ops
from stabletriton_jax.compile import (
    PLATFORM_BINDINGS,
    CompileConfig,
    resolve_binding,
)


def test_gpu_platform_binding_table():
    b = resolve_binding(CompileConfig(), platform="gpu")
    assert {b[op] for op in ("attention", "attention_qkv", "attention_kv")} == {"cudnn"}
    assert b["group_norm"] == "bf16apply" and b["layer_norm"] == "bf16apply"
    # convs and GEMMs stay on the plain ops: XLA hands them to cuDNN/cuBLAS
    assert "conv2d" not in b and "linear" not in b


def test_cpu_platform_binding_is_plain_reference():
    assert resolve_binding(CompileConfig(), platform="cpu") == {}


def test_default_platform_is_the_running_backend():
    assert jax.default_backend() == "cpu"
    assert resolve_binding(CompileConfig()) == resolve_binding(
        CompileConfig(), platform="cpu")


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no op binding"):
        resolve_binding(CompileConfig(), platform=platform)


@pytest.mark.parametrize("platform", ["gpu", "cpu", "rocm"])
def test_reference_backend_is_plain_on_every_platform(platform):
    assert resolve_binding(CompileConfig(backend="reference"),
                           platform=platform) == {}


def test_overrides_apply_over_platform_binding():
    cfg = CompileConfig(overrides=(("attention_qkv", "reference"),
                                   ("group_norm", "onepass")))
    b = resolve_binding(cfg, platform="gpu")
    assert b["attention_qkv"] == "reference"
    assert b["attention_kv"] == "cudnn"
    assert b["group_norm"] == "onepass"


def test_unregistered_override_raises():
    with pytest.raises(ValueError, match="not registered"):
        resolve_binding(CompileConfig(overrides=(("conv2d", "direct"),)))


def test_unknown_backend_name_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_binding(CompileConfig(backend="pallas"))


def test_every_platform_binding_backend_is_registered():
    reg = ops.registered_ops()
    for platform, binding in PLATFORM_BINDINGS.items():
        for op, backend in binding.items():
            assert backend in reg[op], (platform, op, backend)
