"""Torch-module ingestion: the graph-capture front of ``compile()``.

The reference "captures" a model by torch.fx-tracing it (reference
``src/stabletriton/optimization.py:35``). Here the capture step is simpler
and more robust: read the torch module's *config* (topology) and *state_dict*
(weights), rebuild both in this framework, and return the functional model.
This is the role symbolic_trace played — see SURVEY.md §7 ("a thin
graph-capture front ... plays the role symbolic_trace played").

torch is imported lazily so JAX hosts never need it unless they actually hand
us a torch module.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from stabletriton_jax.io.safetensors_io import convert_state_dict
from stabletriton_jax.models.unet import UNetConfig


def state_dict_to_params(module: Any, dtype=None) -> dict[str, np.ndarray]:
    """torch nn.Module -> framework param dict (names kept, layout converted)."""
    sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    return convert_state_dict(sd, dtype=dtype)


def unet_config_from_diffusers(config: Any) -> UNetConfig:
    """Map a diffusers UNet2DConditionModel config (dict-like) to UNetConfig."""
    get = lambda k, d=None: (
        config.get(k, d) if isinstance(config, dict) else getattr(config, k, d)
    )
    tf_layers = get("transformer_layers_per_block", 1)
    if isinstance(tf_layers, int):
        tf_layers = (tf_layers,) * len(get("block_out_channels"))
    block_out = tuple(get("block_out_channels"))
    # diffusers' legacy naming: attention_head_dim actually carries the *head
    # count*. A per-level list (SDXL: [5,10,20]) implies a fixed head_dim
    # (channels/heads, 64); a scalar (SD1.x: 8) implies a fixed head COUNT.
    heads = get("num_attention_heads") or get("attention_head_dim")
    fixed_num_heads = None
    if isinstance(heads, (list, tuple)):
        head_dim = block_out[-1] // heads[-1]
    else:
        head_dim, fixed_num_heads = 64, int(heads)
    return UNetConfig(
        fixed_num_heads=fixed_num_heads,
        in_channels=get("in_channels", 4),
        out_channels=get("out_channels", 4),
        block_out_channels=block_out,
        down_block_types=tuple(get("down_block_types")),
        layers_per_block=get("layers_per_block", 2),
        transformer_layers_per_block=tuple(tf_layers),
        attention_head_dim=head_dim,
        cross_attention_dim=get("cross_attention_dim", 2048),
        norm_num_groups=get("norm_num_groups", 32),
        norm_eps=get("norm_eps", 1e-5),
        # SD1.x/2.x have no added conditioning (addition_embed_type is None)
        addition_time_embed_dim=(
            get("addition_time_embed_dim", 256)
            if get("addition_embed_type", "text_time") == "text_time" else None
        ),
        projection_class_embeddings_input_dim=(
            get("projection_class_embeddings_input_dim", 2816)
            if get("addition_embed_type", "text_time") == "text_time" else None
        ),
        flip_sin_to_cos=get("flip_sin_to_cos", True),
        freq_shift=get("freq_shift", 0.0),
    )
