"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to run
without a GPU. What the phases measure is only meaningful on the card; here
they check wiring: shapes, comparisons, the serving batch, the mesh runs."""

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from stabletriton_jax.compile import CompileConfig, resolve_binding
from stabletriton_jax.models.unet import tiny_unet_config
from stabletriton_jax.runtime.pipeline import make_tiny_pipeline


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_compile_and_unet_parity_tiny():
    cfg = tiny_unet_config()
    ccfg = CompileConfig(dtype="bfloat16")
    step, pre = chip_smoke.phase_compile(cfg, 8, ccfg)
    mse, params = chip_smoke.phase_unet(cfg, 8, compiled=step, pre=pre, ccfg=ccfg)
    assert 0.0 <= mse < chip_smoke.MSE_GATE
    assert any(k.endswith(".to_qkv.weight") for k in params)


def test_phase_kernels_tiny():
    rows = chip_smoke.phase_kernels(
        [("self", "attention_qkv", 2, 2, 64, 64, 16, jnp.bfloat16),
         ("cross", "attention_kv", 2, 2, 64, 77, 16, jnp.bfloat16),
         ("vae", "attention", 1, 1, 64, 64, 32, jnp.float32)],
        [("8² 16->16 +tbias", 2, 8, 16, 16, False),
         ("8² 16->32 +res", 2, 8, 16, 32, True)],
        binding=resolve_binding(CompileConfig()), time_it=False)
    assert len(rows) == 5 and all(r["ok"] for r in rows)


def test_phase_txt2img_and_serving_tiny():
    pipe = make_tiny_pipeline(CompileConfig(dtype="float32"))
    img = chip_smoke.phase_txt2img(pipe, 32, 2)
    assert img.shape == (1, 32, 32, 3)
    imgs = chip_smoke.phase_serving(pipe, 32, 2)
    assert len(imgs) == 3
    # txt2img's signature, and the batched no-CFG pair's batch-2 program
    assert len(pipe.cache_signatures()) == 2


def test_phase_four_on_virtual_cpu_mesh():
    tiny = make_tiny_pipeline()
    configs = (tiny.unet_config, tiny.clip_config, tiny.clip2_config,
               tiny.vae_config)
    rows = chip_smoke.phase_four(configs, jax.devices()[:4], size=32, steps=2)
    assert [r["activation_all_gathers"] for r in rows] == [0, 0]


def test_id_tokenizer_is_deterministic_and_framed():
    tok = chip_smoke.IdTokenizer(100, 98, 99)
    a = tok.encode_batch(["a cat", "a dog"], max_len=16)
    assert (a == tok.encode_batch(["a cat", "a dog"], max_len=16)).all()
    assert a.shape == (2, 16) and (a[:, 0] == 98).all()
    assert (a[0] != a[1]).any() and a.max() < 100
