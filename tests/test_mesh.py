"""Mesh/sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.models.unet import init_unet_params, tiny_unet_config, unet_apply
from stabletriton_jax.runtime import mesh as mesh_mod


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return mesh_mod.make_mesh(data=4, model=2, devices=jax.devices()[:8])


def test_mesh_axes(mesh8):
    assert mesh8.shape == {"data": 4, "model": 2}


def test_param_sharding_rules(mesh8):
    ps = mesh_mod.param_sharding(
        "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight",
        (64, 64), mesh8,
    )
    assert ps.spec == jax.sharding.PartitionSpec(None, "model")
    ps = mesh_mod.param_sharding(
        "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0.weight",
        (64, 64), mesh8,
    )
    assert ps.spec == jax.sharding.PartitionSpec("model", None)
    # conv weights replicate
    ps = mesh_mod.param_sharding("conv_in.weight", (3, 3, 4, 32), mesh8)
    assert ps.spec == jax.sharding.PartitionSpec()
    # odd shapes replicate rather than shard unevenly
    ps = mesh_mod.param_sharding("x.ff.net.0.proj.weight", (32, 51), mesh8)
    assert ps.spec == jax.sharding.PartitionSpec()


def test_param_sharding_fused_and_boundary_keys_replicate(mesh8):
    """Fused .to_qkv./.to_kv., the GEGLU up, and the block-boundary 1x1s
    must REPLICATE: a contiguous "model" split of their column concats is
    not head/gate-aligned, and sharding them was measured (HLO audit) to
    insert per-layer channel all-gathers inside the scan. TP pipelines keep
    the projections unfused instead (pipeline.__post_init__)."""
    for name, shape in [
        ("down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_qkv.weight",
         (64, 192)),
        ("down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_kv.weight",
         (32, 128)),
        ("down_blocks.1.attentions.0.transformer_blocks.0.ff.net.0.proj.weight",
         (64, 512)),
        ("down_blocks.1.attentions.0.proj_in.weight", (64, 64)),
        ("decoder.mid_block.attentions.0.to_q.weight", (16, 16)),  # VAE h=1
    ]:
        ps = mesh_mod.param_sharding(name, shape, mesh8)
        assert ps.spec == jax.sharding.PartitionSpec(), name


def test_txt2img_hlo_free_of_activation_allgathers(mesh8):
    """The partitioning tripwire: compile the whole fused txt2img on
    dp4 x tp2 and assert no activation-sized all-gather survives — an
    unpartitionable op or a mis-specced param table would insert
    (B, S, H*D) gathers inside the scan body."""
    import numpy as np
    from stabletriton_jax.compile import CompileConfig
    from stabletriton_jax.runtime.pipeline import _seed_vector, make_tiny_pipeline

    pipe = make_tiny_pipeline(CompileConfig(dtype="float32"), mesh=mesh8)
    mp = pipe.clip_config.max_position_embeddings
    ids = jnp.asarray(np.full((4, mp), 5, np.int32))
    fn = pipe._txt2img_program(4, 32, 32, 2, 5.0, "euler", False, None, None)
    neg1 = jnp.asarray(pipe.clip_config.empty_prompt_ids(4, mp))
    neg2 = jnp.asarray(pipe.clip2_config.empty_prompt_ids(4, mp))
    hlo = fn.lower(pipe.params, ids, ids, neg1, neg2,
                   _seed_vector(0, 4)).compile().as_text()
    bad = mesh_mod.audit_hlo_collectives(hlo)
    assert not bad, bad[:5]


def test_sharded_pipeline_matches_unsharded(mesh8):
    """SDXLPipeline with a tp>1 mesh == the same pipeline unsharded.

    With model > 1 the pipeline keeps the attention projections UNFUSED (a
    contiguous "model" split of the fused [q|k|v] concat is not head-aligned)
    and shards them column-parallel; the single-chip reference pipeline still
    fuses. Output parity across that layout difference is the point."""
    import numpy as np
    from stabletriton_jax.compile import CompileConfig
    from stabletriton_jax.runtime.pipeline import make_tiny_pipeline

    ccfg = CompileConfig(dtype="float32")
    ref = make_tiny_pipeline(ccfg)
    assert any(".to_qkv." in k for k in ref.params["unet"])  # single-chip fuses
    shp = make_tiny_pipeline(ccfg, mesh=mesh8)
    fused = [k for k in shp.params["unet"] if ".to_qkv." in k or ".to_kv." in k]
    assert not fused, fused  # tensor-parallel keeps head-aligned unfused keys
    qs = [k for k in shp.params["unet"] if k.endswith(".attn1.to_q.weight")]
    assert qs
    for k in qs:
        assert tuple(shp.params["unet"][k].sharding.spec) == (None, "model"), k

    mp = ref.clip_config.max_position_embeddings
    ids = np.full((4, mp), 5, np.int32)  # batch == data axis size
    ids[:, -1] = 99
    ids = jnp.asarray(ids)
    a = ref.txt2img(ids, ids, height=32, width=32, steps=2, seed=0)
    b = shp.txt2img(ids, ids, height=32, width=32, steps=2, seed=0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_sharded_unet_matches_unsharded(mesh8):
    """dp x tp sharded forward == single-device forward (XLA collectives are
    numerically transparent here)."""
    cfg = tiny_unet_config()
    params = init_unet_params(cfg, 0)
    rng = np.random.default_rng(0)
    b = 4  # data axis size
    sample = jnp.asarray(rng.standard_normal((b, 16, 16, 4), dtype=np.float32))
    t = jnp.full((b,), 500.0)
    ehs = jnp.asarray(rng.standard_normal((b, 7, cfg.cross_attention_dim), dtype=np.float32))
    te = jnp.asarray(rng.standard_normal((b, 16), dtype=np.float32))
    ti = jnp.zeros((b, 6))

    expected = unet_apply(cfg, params, sample, t, ehs, te, ti)

    sp = mesh_mod.shard_params(params, mesh8)
    bs = mesh_mod.batch_sharding(mesh8)
    args = [jax.device_put(x, bs) for x in (sample, t, ehs, te, ti)]
    got = jax.jit(lambda p, *a: unet_apply(cfg, p, *a))(sp, *args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), atol=2e-4)
