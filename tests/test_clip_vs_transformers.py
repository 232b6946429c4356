"""Cross-validation: our functional CLIP vs HuggingFace transformers' torch
CLIPTextModel with identical (random) weights.

This is the strongest fidelity evidence available offline: a whole-submodel
numeric parity check against an independent implementation — the role the
reference's "trace the real UNet with real HF fp16 weights" integration
checks played (SURVEY.md §4), but assertable on CPU.
"""

import numpy as np
import pytest
import torch

from stabletriton_jax.io.torch_ingest import state_dict_to_params
from stabletriton_jax.models import clip as clip_mod

transformers = pytest.importorskip("transformers")


def _hf_tiny(with_projection: bool):
    cfg = transformers.CLIPTextConfig(
        vocab_size=99,
        hidden_size=32,
        intermediate_size=64,
        num_hidden_layers=3,
        num_attention_heads=4,
        max_position_embeddings=16,
        hidden_act="quick_gelu",
        projection_dim=24,
        eos_token_id=98,
        bos_token_id=97,
    )
    cls = (transformers.CLIPTextModelWithProjection if with_projection
           else transformers.CLIPTextModel)
    torch.manual_seed(0)
    return cls(cfg), cfg


def _ours_from(cfg, with_projection: bool):
    return clip_mod.CLIPTextConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        hidden_act=cfg.hidden_act,
        projection_dim=cfg.projection_dim if with_projection else None,
        eos_token_id=cfg.eos_token_id,
    )


@pytest.mark.parametrize("with_projection", [False, True])
def test_clip_matches_transformers(with_projection):
    import jax.numpy as jnp

    hf, cfg = _hf_tiny(with_projection)
    ours_cfg = _ours_from(cfg, with_projection)
    params = {k: jnp.asarray(v) for k, v in
              state_dict_to_params(hf, dtype=np.float32).items()}
    # transformers adds a position_ids buffer in some versions; drop non-params
    params = {k: v for k, v in params.items() if not k.endswith("position_ids")}

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 90, (2, 16), dtype=np.int64)
    ids[:, 0] = 97
    ids[0, 10:] = 98  # eos mid-sequence for pooling check
    ids[1, -1] = 98

    with torch.no_grad():
        out = hf(torch.from_numpy(ids), output_hidden_states=True)

    pen, final, pooled = clip_mod.clip_apply(
        ours_cfg, params, jnp.asarray(ids.astype(np.int32))
    )

    np.testing.assert_allclose(
        np.asarray(pen), out.hidden_states[-2].numpy(), atol=2e-5,
        err_msg="penultimate hidden states diverge",
    )
    np.testing.assert_allclose(
        np.asarray(final), out.last_hidden_state.numpy(), atol=2e-5,
        err_msg="final hidden states diverge",
    )
    if with_projection:
        np.testing.assert_allclose(
            np.asarray(pooled), out.text_embeds.numpy(), atol=2e-5,
            err_msg="pooled/projected output diverges",
        )
