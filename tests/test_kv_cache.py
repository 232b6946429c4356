"""Cross-attention K/V cache: hoisting the loop-invariant context projections
out of the denoise loop (models/unet.precompute_cross_kv) must be numerically
EXACT — the same ops.linear on the same dtype-cast context, just computed once.

Reference parity note: the reference re-ran its K/V projection GEMMs inside
every CUDA-graph replay (the graph captures the whole forward —
``optimizers/cuda/graphs.py``); this cache is a capability this design adds
on top, so the gate here is bit-equality against our own uncached step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.compile import (
    CompileConfig,
    compile_unet,
    compile_unet_kv,
    fuse_attention_projections,
)
from stabletriton_jax.models.unet import (
    init_unet_params,
    precompute_cross_kv,
    tiny_unet_config,
    transformer2d_keys,
    unet_apply,
)


def _inputs(cfg, b=2, lat=8, dtype=jnp.float32):
    rng = np.random.default_rng(0)
    return (
        jnp.asarray(rng.standard_normal((b, lat, lat, cfg.in_channels)), dtype),
        jnp.full((b,), 500.0, jnp.float32),
        jnp.asarray(rng.standard_normal((b, 7, cfg.cross_attention_dim)), dtype),
        jnp.asarray(rng.standard_normal((b, 16)), dtype),
        jnp.asarray(np.tile([64, 64, 0, 0, 64, 64], (b, 1)).astype(np.float32)),
    )


def test_transformer2d_keys_match_params():
    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 0)
    keys = transformer2d_keys(cfg)
    assert keys, "tiny config must have cross-attention"
    for tf_key, depth in keys:
        for k in range(depth):
            assert f"{tf_key}.transformer_blocks.{k}.attn2.to_k.weight" in params


@pytest.mark.parametrize("fused", [False, True])
def test_cached_step_bit_identical(fused):
    """unet_apply with precomputed cross_kv == the inline step, bitwise."""
    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 0)
    if fused:
        params = fuse_attention_projections(params)
    sample, t, ehs, te, tid = _inputs(cfg)
    base = unet_apply(cfg, params, sample, t, ehs, te, tid)
    cache = precompute_cross_kv(cfg, params, ehs)
    # cache entries: fused -> one (B, Sk, 2C) array; unfused -> (k, v) tuples
    some = next(iter(cache.values()))
    assert isinstance(some, tuple) != fused
    cached = unet_apply(cfg, params, sample, t, ehs, te, tid, cross_kv=cache)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(cached))
    # ehs=None works when the cache covers every cross-attention
    cached2 = unet_apply(cfg, params, sample, t, None, te, tid, cross_kv=cache)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(cached2))


def test_partial_cache_without_context_raises():
    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 0)
    sample, t, ehs, te, tid = _inputs(cfg)
    cache = precompute_cross_kv(cfg, params, ehs)
    cache.pop(next(iter(cache)))
    with pytest.raises(KeyError):
        unet_apply(cfg, params, sample, t, None, te, tid, cross_kv=cache)


def test_time_cond_cache_matches_inline():
    """precompute_time_cond batched over T steps == the inline per-step
    time_emb_proj values, and the cached step reproduces the full forward."""
    from stabletriton_jax.models.unet import precompute_time_cond, resnet_keys

    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 0)
    sample, t, ehs, te, tid = _inputs(cfg)
    ts = jnp.asarray([500.0, 250.0, 10.0], jnp.float32)  # 3-step schedule
    tc_all = precompute_time_cond(cfg, params, ts, te, tid)
    assert set(tc_all) == set(resnet_keys(cfg))
    for i, tv in enumerate(ts):
        tc_i = {k: v[i] for k, v in tc_all.items()}
        base = unet_apply(cfg, params, sample,
                          jnp.broadcast_to(tv, (sample.shape[0],)), ehs, te, tid)
        cached = unet_apply(cfg, params, sample,
                            jnp.broadcast_to(tv, (sample.shape[0],)), ehs, te,
                            tid, time_cond=tc_i)
        np.testing.assert_allclose(np.asarray(base), np.asarray(cached),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("backend", ["reference", "platform"])
def test_compile_unet_kv_matches_compile_unet(backend):
    """The (precompute, precompute_time, step) triple from compile_unet_kv
    reproduces the single-call compile_unet under both bindings."""
    cfg = tiny_unet_config()
    ccfg = CompileConfig(backend=backend, dtype="float32")
    params = init_unet_params(cfg, 0)
    if backend != "reference":
        params = fuse_attention_projections(params)
    sample, t, ehs, te, tid = _inputs(cfg)
    fn = compile_unet(cfg, ccfg)
    pre, pre_t, step = compile_unet_kv(cfg, ccfg)
    base = fn(params, sample, t, ehs, te, tid)
    cached = step(params, sample, t, pre(params, ehs), te, tid)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(cached))
    tc = jax.tree.map(lambda a: a[0], pre_t(params, t[:1], te, tid))
    cached_t = step(params, sample, t, pre(params, ehs), te, tid, tc)
    np.testing.assert_allclose(np.asarray(base), np.asarray(cached_t),
                               atol=1e-6, rtol=1e-6)


def test_pipeline_cached_loop_matches_uncached():
    """Whole tiny txt2img: both hoisting caches on vs fully inline must agree
    bitwise."""
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    ids = jnp.zeros((1, 16), jnp.int32)
    pipe_on = make_tiny_pipeline(
        CompileConfig(backend="reference", dtype="float32",
                      cache_cross_kv=True, cache_time_cond=True)
    )
    pipe_off = make_tiny_pipeline(
        CompileConfig(backend="reference", dtype="float32",
                      cache_cross_kv=False, cache_time_cond=False)
    )
    a = pipe_on.txt2img(ids, ids, height=32, width=32, steps=2, seed=7)
    b = pipe_off.txt2img(ids, ids, height=32, width=32, steps=2, seed=7)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_persistent_compile_cache_sets_config(tmp_path, monkeypatch,
                                              restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, enable_persistent_compile_cache
    points jax at exactly that dir and creates it; idempotent on repeat
    calls."""
    import os

    from stabletriton_jax.compile import enable_persistent_compile_cache

    d = str(tmp_path / "xla-cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    got = enable_persistent_compile_cache()
    assert got == d
    assert os.path.isdir(d)
    assert jax.config.jax_compilation_cache_dir == d
    assert enable_persistent_compile_cache() == d


def test_persistent_compile_cache_default_is_in_checkout(monkeypatch,
                                                         restore_cache_dir):
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at one fixed path
    inside the checkout — never under HOME, a temp name, a pid or a time."""
    import os
    import pathlib

    from stabletriton_jax import compile as compile_mod

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = pathlib.Path(__file__).resolve().parent.parent
    expected = str(repo / ".jax_cache")
    assert compile_mod.compile_cache_dir() == expected
    assert compile_mod.enable_persistent_compile_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected
    assert os.path.isdir(expected)
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
