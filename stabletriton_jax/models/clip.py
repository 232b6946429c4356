"""Functional CLIP text encoders (SDXL's dual conditioning stack).

The reference left the two CLIP encoders un-optimized *outside* its envelope
(eager torch in the host pipeline, SURVEY.md §3.4); the BASELINE north star
pulls them on-device into the jitted program. This is a clean-room functional
CLIPTextTransformer: params are a flat {hf_state_dict_key: array} dict (same
transposes as the UNet: linear (in,out)); both SDXL encoders are instances of
the same function with different configs.

SDXL conditioning contract (what the pipeline consumes):
  * per-encoder sequence features = hidden_states[-2] (penultimate layer);
  * pooled = EOS-token hidden state after final_layer_norm @ text_projection
    (encoder 2 only);
  * prompt embedding = concat(enc1_feats 768, enc2_feats 1280) -> 2048.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = float(-1e30)  # finite -inf stand-in (avoids nan from inf - inf)


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: int | None = None
    eos_token_id: int = 49407
    bos_token_id: int = 49406
    # padding token the matching tokenizer uses; None means "pad with EOS"
    # (OpenAI CLIP / SDXL encoder-1 convention; SDXL encoder 2 pads with 0)
    pad_token_id: int | None = None
    layer_norm_eps: float = 1e-5

    def empty_prompt_ids(self, batch: int, total_len: int | None = None) -> np.ndarray:
        """(batch, total_len) token ids of the empty prompt "" — BOS, EOS, then
        padding — per 77-token window; the diffusers default for a missing
        negative prompt (NOT all-zeros, which mis-pools the EOS argmax)."""
        mp = self.max_position_embeddings
        total = mp if total_len is None else total_len
        assert total % mp == 0, (total, mp)
        pad = self.eos_token_id if self.pad_token_id is None else self.pad_token_id
        row = np.full((mp,), pad, np.int32)
        row[0] = self.bos_token_id
        row[1] = self.eos_token_id
        return np.broadcast_to(np.tile(row, total // mp), (batch, total)).copy()


def sdxl_text_encoder_config() -> CLIPTextConfig:
    """openai/clip-vit-large-patch14 text tower (SDXL text_encoder)."""
    return CLIPTextConfig()


def sdxl_text_encoder_2_config() -> CLIPTextConfig:
    """laion CLIP-bigG text tower (SDXL text_encoder_2)."""
    return CLIPTextConfig(
        hidden_size=1280,
        num_layers=32,
        num_heads=20,
        intermediate_size=5120,
        hidden_act="gelu",
        projection_dim=1280,
        pad_token_id=0,  # SDXL's tokenizer_2 pads with "!" (id 0)
    )


def sd15_text_encoder_config() -> CLIPTextConfig:
    """SD1.x text encoder == openai CLIP-L (same tower as SDXL's encoder 1)."""
    return CLIPTextConfig()


def sd2_text_encoder_config() -> CLIPTextConfig:
    """SD2.x text encoder: OpenCLIP ViT-H text tower (1024-wide, 24 layers,
    gelu); SD2 conditions on the penultimate layer (clip_skip=2)."""
    return CLIPTextConfig(
        hidden_size=1024,
        num_layers=24,
        num_heads=16,
        intermediate_size=4096,
        hidden_act="gelu",
    )


def tiny_clip_config() -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position_embeddings=16, projection_dim=24,
        eos_token_id=99, bos_token_id=98,
    )


def clip_param_shapes(cfg: CLIPTextConfig) -> dict[str, tuple[int, ...]]:
    d, inter = cfg.hidden_size, cfg.intermediate_size
    shapes: dict[str, tuple[int, ...]] = {
        "text_model.embeddings.token_embedding.weight": (cfg.vocab_size, d),
        "text_model.embeddings.position_embedding.weight": (cfg.max_position_embeddings, d),
        "text_model.final_layer_norm.weight": (d,),
        "text_model.final_layer_norm.bias": (d,),
    }
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{pre}.self_attn.{proj}.weight"] = (d, d)
            shapes[f"{pre}.self_attn.{proj}.bias"] = (d,)
        for ln in ("layer_norm1", "layer_norm2"):
            shapes[f"{pre}.{ln}.weight"] = (d,)
            shapes[f"{pre}.{ln}.bias"] = (d,)
        shapes[f"{pre}.mlp.fc1.weight"] = (d, inter)
        shapes[f"{pre}.mlp.fc1.bias"] = (inter,)
        shapes[f"{pre}.mlp.fc2.weight"] = (inter, d)
        shapes[f"{pre}.mlp.fc2.bias"] = (d,)
    if cfg.projection_dim is not None:
        shapes["text_projection.weight"] = (d, cfg.projection_dim)
    return shapes


def init_clip_params(cfg: CLIPTextConfig, rng: jax.Array | int = 0, dtype=jnp.float32):
    if isinstance(rng, int):
        rng = jax.random.PRNGKey(rng)
    shapes = clip_param_shapes(cfg)
    out = {}
    keys = jax.random.split(rng, len(shapes))
    for k, (name, shape) in zip(keys, sorted(shapes.items())):
        if name.endswith(".bias"):
            out[name] = jnp.zeros(shape, dtype)
        elif "layer_norm" in name or "final_layer_norm" in name:
            out[name] = jnp.ones(shape, dtype)
        else:
            fan = shape[0] if len(shape) > 1 else shape[0]
            out[name] = (
                jax.random.normal(k, shape, jnp.float32) / np.sqrt(fan)
            ).astype(dtype)
    return out


def _act(x, kind: str):
    if kind == "quick_gelu":
        return x * jax.nn.sigmoid(1.702 * x)
    if kind == "gelu":
        return jax.nn.gelu(x, approximate=False)
    raise ValueError(kind)


def _layer_norm(x, w, b, eps):
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    return ((xf - mean) * jax.lax.rsqrt(var + eps) * w + b).astype(x.dtype)


def _causal_self_attn(p, pre: str, x, cfg: CLIPTextConfig):
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    scale = 1.0 / np.sqrt(hd)

    def proj(name):
        return x @ p[f"{pre}.self_attn.{name}.weight"] + p[f"{pre}.self_attn.{name}.bias"]

    q = proj("q_proj").reshape(b, s, h, hd).transpose(0, 2, 1, 3)
    k = proj("k_proj").reshape(b, s, h, hd).transpose(0, 2, 1, 3)
    v = proj("v_proj").reshape(b, s, h, hd).transpose(0, 2, 1, 3)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    logits = logits * scale
    causal = jnp.tril(jnp.ones((s, s), bool))
    logits = jnp.where(causal[None, None], logits, NEG_INF)
    w = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhqk,bhkd->bhqd", w, v).transpose(0, 2, 1, 3).reshape(b, s, d)
    return out @ p[f"{pre}.self_attn.out_proj.weight"] + p[f"{pre}.self_attn.out_proj.bias"]


def clip_apply(
    cfg: CLIPTextConfig,
    params: dict[str, jax.Array],
    input_ids: jax.Array,  # (B, S) int32, padded to max_position_embeddings
):
    """Returns (penultimate_hidden, final_hidden, pooled_or_None).

    penultimate_hidden = hidden_states[-2] (what SDXL conditions on);
    pooled = argmax(EOS) token of final_layer_norm output @ text_projection.
    """
    p = params
    b, s = input_ids.shape
    x = p["text_model.embeddings.token_embedding.weight"][input_ids]
    x = x + p["text_model.embeddings.position_embedding.weight"][None, :s]

    penultimate = None
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        if i == cfg.num_layers - 1:
            penultimate = x
        h = _layer_norm(x, p[f"{pre}.layer_norm1.weight"], p[f"{pre}.layer_norm1.bias"],
                        cfg.layer_norm_eps)
        x = x + _causal_self_attn(p, pre, h, cfg)
        h = _layer_norm(x, p[f"{pre}.layer_norm2.weight"], p[f"{pre}.layer_norm2.bias"],
                        cfg.layer_norm_eps)
        h = _act(h @ p[f"{pre}.mlp.fc1.weight"] + p[f"{pre}.mlp.fc1.bias"], cfg.hidden_act)
        x = x + (h @ p[f"{pre}.mlp.fc2.weight"] + p[f"{pre}.mlp.fc2.bias"])

    final = _layer_norm(
        x, p["text_model.final_layer_norm.weight"], p["text_model.final_layer_norm.bias"],
        cfg.layer_norm_eps,
    )
    pooled = None
    if cfg.projection_dim is not None:
        # EOS pooling: highest token id == eos (HF uses argmax of eos mask)
        eos_pos = jnp.argmax((input_ids == cfg.eos_token_id).astype(jnp.int32), axis=-1)
        pooled_h = final[jnp.arange(b), eos_pos]
        pooled = pooled_h @ p["text_projection.weight"]
    return penultimate, final, pooled


def clip_apply_chunked(cfg: CLIPTextConfig, params: dict, ids: jax.Array):
    """Long-prompt encoding: ids (B, k*max_pos) are encoded as k independent
    77-token windows (the A1111 convention) and their hidden states
    re-concatenated along the sequence — cross-attention then sees the full
    prompt. Pooled output comes from the first window. Returns the same
    (penultimate, final, pooled) triple as clip_apply."""
    b, total = ids.shape
    mp = cfg.max_position_embeddings
    assert total % mp == 0, (total, mp)
    k = total // mp
    if k == 1:
        return clip_apply(cfg, params, ids)
    flat = ids.reshape(b * k, mp)
    pen, final, pooled = clip_apply(cfg, params, flat)
    pen = pen.reshape(b, k * mp, -1)
    final = final.reshape(b, k * mp, -1)
    if pooled is not None:
        pooled = pooled.reshape(b, k, -1)[:, 0]
    return pen, final, pooled


def encode_sdxl_prompts(
    cfg1: CLIPTextConfig, params1: dict,
    cfg2: CLIPTextConfig, params2: dict,
    ids1: jax.Array, ids2: jax.Array,
):
    """Dual-encoder SDXL conditioning: (B, k*77)+(B, k*77) token ids ->
    (prompt_embeds (B, k*77, 2048), pooled (B, 1280)). k > 1 windows encode
    the long-prompt convention (clip_apply_chunked)."""
    h1, _, _ = clip_apply_chunked(cfg1, params1, ids1)
    h2, _, pooled = clip_apply_chunked(cfg2, params2, ids2)
    return jnp.concatenate([h1, h2], axis=-1), pooled
