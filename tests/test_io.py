"""io layer tests: safetensors parsing, layout conversion, LoRA patching."""

import numpy as np
import pytest
import torch

from stabletriton_jax.io import lora as lora_mod
from stabletriton_jax.io import safetensors_io as st


def test_read_safetensors_roundtrip(tmp_path):
    import safetensors.torch as st_torch

    tensors = {
        "a.weight": torch.randn(4, 6),
        "b.bias": torch.arange(5, dtype=torch.float16),
        "c.weight": torch.randn(2, 3, 3, 3).to(torch.bfloat16),
    }
    path = tmp_path / "x.safetensors"
    st_torch.save_file(tensors, str(path))

    out = st.read_safetensors(path)
    np.testing.assert_allclose(out["a.weight"], tensors["a.weight"].numpy())
    np.testing.assert_allclose(out["b.bias"], tensors["b.bias"].numpy())
    # bf16 widened to fp32, exact
    np.testing.assert_allclose(
        out["c.weight"], tensors["c.weight"].to(torch.float32).numpy()
    )


def test_layout_conversion_rules():
    lin = np.arange(12, dtype=np.float32).reshape(3, 4)  # torch (out=3, in=4)
    conv = np.arange(2 * 5 * 3 * 3, dtype=np.float32).reshape(2, 5, 3, 3)  # OIHW
    emb = np.arange(10, dtype=np.float32).reshape(5, 2)
    assert st.to_framework_layout("x.weight", lin).shape == (4, 3)
    assert st.to_framework_layout("x.weight", conv).shape == (3, 3, 5, 2)
    assert st.to_framework_layout("emb.token_embedding.weight", emb).shape == (5, 2)
    assert st.to_framework_layout("x.bias", lin).shape == (3, 4)


def test_convert_state_dict_vae_renames():
    sd = {"mid.attentions.0.query.weight": np.zeros((4, 4), np.float32)}
    out = st.convert_state_dict(sd)
    assert "mid.attentions.0.to_q.weight" in out


def test_validate_against_shapes_errors():
    with pytest.raises(ValueError, match="missing"):
        st.validate_against_shapes({}, {"a.weight": (2, 2)})
    with pytest.raises(ValueError, match="shape"):
        st.validate_against_shapes(
            {"a.weight": np.zeros((3, 3))}, {"a.weight": (2, 2)}
        )


def test_sdxl_checkpoint_shape_contract(tmp_path):
    """A synthetic checkpoint with torch-layout SDXL shapes must load into
    exactly the model's expected shape table (spot-checked subset)."""
    from stabletriton_jax.models.unet import sdxl_base_unet_config, unet_param_shapes

    expected = unet_param_shapes(sdxl_base_unet_config())
    subset = dict(list(sorted(expected.items()))[:40])
    # build the torch-layout version of the subset
    sd = {}
    for name, shape in subset.items():
        if name.endswith(".weight") and len(shape) == 2:
            sd[name] = np.zeros((shape[1], shape[0]), np.float32)
        elif len(shape) == 4:
            sd[name] = np.zeros((shape[3], shape[2], shape[0], shape[1]), np.float32)
        else:
            sd[name] = np.zeros(shape, np.float32)
    params = st.convert_state_dict(sd)
    st.validate_against_shapes(params, subset)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def _base_params():
    return {"down_blocks.0.attn.to_q.weight": np.ones((8, 6), np.float32)}  # (in, out)


def test_lora_diffusers_format():
    params = _base_params()
    r = 2
    down = np.full((r, 8), 0.5, np.float32)   # (r, in)
    up = np.full((6, r), 0.25, np.float32)    # (out, r)
    lora = {
        "unet.down_blocks.0.attn.to_q.lora_A.weight": down,
        "unet.down_blocks.0.attn.to_q.lora_B.weight": up,
    }
    out = lora_mod.apply_lora(params, lora, scale=2.0)
    # delta = (up@down).T * (2*r/r) = each elem 0.25*0.5*r=0.25 -> *2 = 0.5
    np.testing.assert_allclose(
        out["down_blocks.0.attn.to_q.weight"], 1.0 + 0.5, atol=1e-6
    )
    # base untouched
    np.testing.assert_allclose(params["down_blocks.0.attn.to_q.weight"], 1.0)


def test_lora_kohya_format_with_alpha():
    params = _base_params()
    r = 4
    lora = {
        "lora_unet_down_blocks_0_attn_to_q.lora_down.weight": np.full((r, 8), 0.1, np.float32),
        "lora_unet_down_blocks_0_attn_to_q.lora_up.weight": np.full((6, r), 0.2, np.float32),
        "lora_unet_down_blocks_0_attn_to_q.alpha": np.float32(2.0),
    }
    out = lora_mod.apply_lora(params, lora, scale=1.0)
    # delta = 0.1*0.2*r * (alpha/r) = 0.02*2 = 0.04
    np.testing.assert_allclose(
        out["down_blocks.0.attn.to_q.weight"], 1.04, atol=1e-6
    )


def test_lora_no_match_raises():
    with pytest.raises(ValueError, match="no LoRA"):
        lora_mod.apply_lora(_base_params(), {"lora_unet_nonexistent.lora_down.weight":
                                             np.zeros((2, 8), np.float32)})
