"""Functional SDXL UNet, written against the op registry.

Role in the stack: the analog of the reference's clean-room, fx-traceable UNet
re-implementation (reference ``src/stabletriton/optimizers/unet_pt.py`` — a
541-line torch module that exists only because stock Diffusers is untraceable).
Here the same idea is taken further: the model is a *pure function* of
``(config, params, inputs)`` — trivially jittable, shardable, and scannable —
and every hot op goes through ``stabletriton_jax.ops`` so the compile step can
bind fused library kernels without touching model code.

Weight compatibility: ``params`` is a flat ``{hf_state_dict_key: array}`` dict
using the exact Diffusers SDXL UNet key names (the reference loads HF weights
via ``load_state_dict`` — ``implementations/Diffusers/load_sdxl_pipeline.py:24-25``;
we load the same safetensors into this pytree). Layout differs from torch:
linear weights are stored (in, out) and conv weights HWIO; the ingestion code
(``stabletriton_jax.io``) performs those transposes.

Data layout: NHWC activations (channels-last, as cuDNN prefers), fp32 or bf16.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from stabletriton_jax import ops

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UNetConfig:
    """Topology of a UNet2DConditionModel (defaults = SDXL-base).

    Reference topology hardcoded at ``unet_pt.py:435-464``:
    DownBlock2D(320) -> CrossAttnDown(640, 2 tf layers) -> CrossAttnDown(1280, 10)
    -> Mid(1280, 10) -> mirrored up path; dual time conditioning with 2816-wide
    add_embedding (``unet_pt.py:469-488``).
    """

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280)
    down_block_types: tuple[str, ...] = (
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: tuple[int, ...] = (1, 2, 10)
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_norm_eps: float = 1e-6
    # None = no added (text_time) conditioning — SD1.x/2.x UNets
    addition_time_embed_dim: int | None = 256
    projection_class_embeddings_input_dim: int | None = 2816
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # SD1.x/2.x fix the *number* of heads per level (head_dim varies);
    # SDXL fixes head_dim=64 (head count varies). None = use attention_head_dim.
    fixed_num_heads: int | None = None
    # mid-block transformer depth; None = reuse the deepest cross-attn level's
    # (SDXL-base: 10). The refiner needs this explicit (its last *down* level
    # is conv-only but its mid block still has 4 transformer layers).
    mid_block_layers: int | None = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def mid_transformer_layers(self) -> int:
        if self.mid_block_layers is not None:
            return self.mid_block_layers
        # deepest CrossAttn level's depth
        depth = self.transformer_layers_per_block[0]
        for t, d in zip(self.down_block_types, self.transformer_layers_per_block):
            if t == "CrossAttnDownBlock2D":
                depth = d
        return depth

    @property
    def up_block_types(self) -> tuple[str, ...]:
        mapping = {"DownBlock2D": "UpBlock2D", "CrossAttnDownBlock2D": "CrossAttnUpBlock2D"}
        return tuple(mapping[t] for t in reversed(self.down_block_types))

    def num_heads(self, channels: int) -> int:
        if self.fixed_num_heads is not None:
            assert channels % self.fixed_num_heads == 0
            return self.fixed_num_heads
        assert channels % self.attention_head_dim == 0
        return channels // self.attention_head_dim

    @property
    def has_addition_embedding(self) -> bool:
        return self.projection_class_embeddings_input_dim is not None


def sdxl_base_unet_config() -> UNetConfig:
    return UNetConfig()


def sd15_unet_config() -> UNetConfig:
    """Stable Diffusion 1.x UNet (runwayml/stable-diffusion-v1-5): 4 levels,
    conv-only innermost, 8 heads at every level (head_dim varies), 768-wide
    cross attention, no added (text_time) conditioning."""
    return UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=(
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        transformer_layers_per_block=(1, 1, 1, 1),
        cross_attention_dim=768,
        fixed_num_heads=8,
        addition_time_embed_dim=None,
        projection_class_embeddings_input_dim=None,
        mid_block_layers=1,
    )


def sd21_unet_config() -> UNetConfig:
    """Stable Diffusion 2.x UNet: SD1.x topology with 1024-wide cross
    attention and head_dim 64 per level (like SDXL)."""
    return UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=(
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        transformer_layers_per_block=(1, 1, 1, 1),
        cross_attention_dim=1024,
        attention_head_dim=64,
        addition_time_embed_dim=None,
        projection_class_embeddings_input_dim=None,
        mid_block_layers=1,
    )


def sdxl_refiner_unet_config() -> UNetConfig:
    """SDXL-refiner topology (stabilityai/stable-diffusion-xl-refiner-1.0):
    4 levels (384/768/1536/1536), outermost and innermost levels conv-only,
    4 transformer layers per cross-attn level, 1280-wide cross attention,
    2560-wide add_embedding (pooled 1280 + 5 time_ids x 256 — the refiner's
    sixth micro-conditioning slot is the aesthetic score)."""
    return UNetConfig(
        block_out_channels=(384, 768, 1536, 1536),
        down_block_types=(
            "DownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        transformer_layers_per_block=(1, 4, 4, 1),
        cross_attention_dim=1280,
        projection_class_embeddings_input_dim=2560,
    )


def tiny_unet_config() -> UNetConfig:
    """Small config with the same structural features (for CPU tests)."""
    return UNetConfig(
        block_out_channels=(32, 64),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=(1, 1),
        attention_head_dim=16,
        cross_attention_dim=32,
        norm_num_groups=8,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=8 * 6 + 16,  # 6 time_ids + text_embeds
    )


# ---------------------------------------------------------------------------
# parameter construction (shapes identical to the HF checkpoint, our layout)
# ---------------------------------------------------------------------------


class _ShapeBuilder:
    """Collects {key: shape} for every parameter; used for init and validation."""

    def __init__(self):
        self.shapes: dict[str, tuple[int, ...]] = {}

    def conv(self, key: str, cin: int, cout: int, k: int = 3):
        self.shapes[f"{key}.weight"] = (k, k, cin, cout)  # HWIO
        self.shapes[f"{key}.bias"] = (cout,)

    def linear(self, key: str, cin: int, cout: int, bias: bool = True):
        self.shapes[f"{key}.weight"] = (cin, cout)  # (in, out)
        if bias:
            self.shapes[f"{key}.bias"] = (cout,)

    def norm(self, key: str, c: int):
        self.shapes[f"{key}.weight"] = (c,)
        self.shapes[f"{key}.bias"] = (c,)


def _resnet_shapes(b: _ShapeBuilder, key: str, cin: int, cout: int, temb: int):
    b.norm(f"{key}.norm1", cin)
    b.conv(f"{key}.conv1", cin, cout)
    b.linear(f"{key}.time_emb_proj", temb, cout)
    b.norm(f"{key}.norm2", cout)
    b.conv(f"{key}.conv2", cout, cout)
    if cin != cout:
        b.conv(f"{key}.conv_shortcut", cin, cout, k=1)


def _transformer_shapes(b: _ShapeBuilder, key: str, c: int, cfg: UNetConfig, layers: int):
    b.norm(f"{key}.norm", c)
    b.linear(f"{key}.proj_in", c, c)
    for k in range(layers):
        tb = f"{key}.transformer_blocks.{k}"
        b.norm(f"{tb}.norm1", c)
        b.linear(f"{tb}.attn1.to_q", c, c, bias=False)
        b.linear(f"{tb}.attn1.to_k", c, c, bias=False)
        b.linear(f"{tb}.attn1.to_v", c, c, bias=False)
        b.linear(f"{tb}.attn1.to_out.0", c, c)
        b.norm(f"{tb}.norm2", c)
        b.linear(f"{tb}.attn2.to_q", c, c, bias=False)
        b.linear(f"{tb}.attn2.to_k", cfg.cross_attention_dim, c, bias=False)
        b.linear(f"{tb}.attn2.to_v", cfg.cross_attention_dim, c, bias=False)
        b.linear(f"{tb}.attn2.to_out.0", c, c)
        b.norm(f"{tb}.norm3", c)
        b.linear(f"{tb}.ff.net.0.proj", c, c * 8)  # GEGLU: 2 * (4c)
        b.linear(f"{tb}.ff.net.2", c * 4, c)
    b.linear(f"{key}.proj_out", c, c)


def unet_param_shapes(cfg: UNetConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter key (Diffusers SDXL naming) and its shape in our layout."""
    b = _ShapeBuilder()
    temb = cfg.time_embed_dim
    ch0 = cfg.block_out_channels[0]

    b.conv("conv_in", cfg.in_channels, ch0)
    b.linear("time_embedding.linear_1", ch0, temb)
    b.linear("time_embedding.linear_2", temb, temb)
    if cfg.has_addition_embedding:
        b.linear("add_embedding.linear_1", cfg.projection_class_embeddings_input_dim, temb)
        b.linear("add_embedding.linear_2", temb, temb)

    # down path
    cin = ch0
    for i, btype in enumerate(cfg.down_block_types):
        cout = cfg.block_out_channels[i]
        for j in range(cfg.layers_per_block):
            _resnet_shapes(b, f"down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout, temb)
            if btype == "CrossAttnDownBlock2D":
                _transformer_shapes(
                    b, f"down_blocks.{i}.attentions.{j}", cout, cfg,
                    cfg.transformer_layers_per_block[i],
                )
        if i < len(cfg.down_block_types) - 1:
            b.conv(f"down_blocks.{i}.downsamplers.0.conv", cout, cout)
        cin = cout

    # mid
    cmid = cfg.block_out_channels[-1]
    _resnet_shapes(b, "mid_block.resnets.0", cmid, cmid, temb)
    _transformer_shapes(b, "mid_block.attentions.0", cmid, cfg,
                        cfg.mid_transformer_layers)
    _resnet_shapes(b, "mid_block.resnets.1", cmid, cmid, temb)

    # up path (mirrors diffusers: layers_per_block + 1 resnets, skip-concat inputs)
    skip_channels = _skip_channel_stack(cfg)
    rev_channels = list(reversed(cfg.block_out_channels))
    prev = cmid
    for i, btype in enumerate(cfg.up_block_types):
        cout = rev_channels[i]
        tf_layers = tuple(reversed(cfg.transformer_layers_per_block))[i]
        for j in range(cfg.layers_per_block + 1):
            skip = skip_channels.pop()
            _resnet_shapes(b, f"up_blocks.{i}.resnets.{j}", prev + skip, cout, temb)
            prev = cout
            if btype == "CrossAttnUpBlock2D":
                _transformer_shapes(b, f"up_blocks.{i}.attentions.{j}", cout, cfg, tf_layers)
        if i < len(cfg.up_block_types) - 1:
            b.conv(f"up_blocks.{i}.upsamplers.0.conv", cout, cout)

    b.norm("conv_norm_out", ch0)
    b.conv("conv_out", ch0, cfg.out_channels)
    return b.shapes


def _skip_channel_stack(cfg: UNetConfig) -> list[int]:
    """Channel count of each down-path residual, in push order (conv_in first)."""
    stack = [cfg.block_out_channels[0]]
    cin = cfg.block_out_channels[0]
    for i in range(len(cfg.down_block_types)):
        cout = cfg.block_out_channels[i]
        stack.extend([cout] * cfg.layers_per_block)
        if i < len(cfg.down_block_types) - 1:
            stack.append(cout)
        cin = cout
    return stack


def init_unet_params(
    cfg: UNetConfig, rng: jax.Array | int = 0, dtype=jnp.float32
) -> dict[str, jax.Array]:
    """Random-init params (tests/benches; real use loads HF safetensors)."""
    if isinstance(rng, int):
        rng = jax.random.PRNGKey(rng)
    shapes = unet_param_shapes(cfg)
    params = {}
    keys = jax.random.split(rng, len(shapes))
    for k, (name, shape) in zip(keys, sorted(shapes.items())):
        if name.endswith(".bias"):
            params[name] = jnp.zeros(shape, dtype)
        elif name.endswith("norm1.weight") or name.endswith("norm2.weight") or \
                name.endswith("norm3.weight") or name.endswith("norm.weight") or \
                name.endswith("conv_norm_out.weight"):
            params[name] = jnp.ones(shape, dtype)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
            params[name] = (
                jax.random.normal(k, shape, jnp.float32) / np.sqrt(max(fan_in, 1))
            ).astype(dtype)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _resnet(p, key: str, x, temb, cfg: UNetConfig, emb=None):
    """ResnetBlock2D: GN+SiLU -> conv -> +time -> GN+SiLU -> conv -> +skip.

    Fusion targets per reference ``optimizations.txt`` (ResNet section), one
    step further: each GN+SiLU+conv triple is a single ``ops.gn_conv2d`` (the
    fused binding normalizes inside the conv kernel's input read), the time
    embedding folds into conv1's per-batch bias, and the shortcut add fuses
    into conv2's epilogue via the residual arg.
    ``emb`` (optional): this resnet's time_emb_proj output precomputed for all
    steps at once (``precompute_time_cond``) — skips the per-step GEMM.
    """
    if emb is None:
        emb = ops.linear(
            jax.nn.silu(temb), p[f"{key}.time_emb_proj.weight"], p[f"{key}.time_emb_proj.bias"]
        )
    # fold the post-conv1 time-embedding add into conv1's bias: a per-batch
    # (B, Cout) bias the conv epilogue applies — one elementwise pass over h
    # fewer when the conv's epilogue does not absorb a standalone `+ emb`
    bias1 = (p[f"{key}.conv1.bias"].astype(jnp.float32)[None, :]
             + emb.astype(jnp.float32))
    h = ops.gn_conv2d(
        x, p[f"{key}.norm1.weight"], p[f"{key}.norm1.bias"],
        p[f"{key}.conv1.weight"], bias1,
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, gn_act="silu",
    )
    if f"{key}.conv_shortcut.weight" in p:
        skip = ops.conv2d(
            x, p[f"{key}.conv_shortcut.weight"], p[f"{key}.conv_shortcut.bias"],
            stride=1, padding=0,
        )
    else:
        skip = x
    return ops.gn_conv2d(
        h, p[f"{key}.norm2.weight"], p[f"{key}.norm2.bias"],
        p[f"{key}.conv2.weight"], p[f"{key}.conv2.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, gn_act="silu",
        residual=skip,
    )


def _attention_layer(p, key: str, x, context, num_heads: int, cached_kv=None):
    """Multi-head attention (self if context is x). Maps to the fused flash
    kernel via ops.attention — the analog of the reference's fuse_attention
    pass (``replace_attention.py:76-92``). Operands stay channel-packed
    (B, S, H*D). Detects fused projection weights when present
    (compile.fuse_attention_projections): one wide qkv/kv dot instead of
    three/two narrow ones — the reference's planned-but-unwired QKV fusion.

    ``cached_kv`` short-circuits the context K/V projections with values
    precomputed once per generation (``precompute_cross_kv``): the text
    conditioning is constant across every denoise step, so re-projecting it
    per step only re-reads ~680 MB of K/V projection weights. A fused
    (B, Sk, 2C) array or a (k, v) tuple, matching what the projections here
    would produce bit-for-bit."""
    if cached_kv is not None:
        q = ops.linear(x, p[f"{key}.to_q.weight"])
        if isinstance(cached_kv, tuple):
            out = ops.attention(q, *cached_kv, num_heads=num_heads)
        else:
            out = ops.attention_kv(q, cached_kv, num_heads=num_heads)
    elif f"{key}.to_qkv.weight" in p:
        # fused-operand op over the one wide projection output; the backends
        # split it into q/k/v — identical HLO to slicing here
        qkv = ops.linear(x, p[f"{key}.to_qkv.weight"])
        out = ops.attention_qkv(qkv, num_heads=num_heads)
    elif f"{key}.to_kv.weight" in p:
        q = ops.linear(x, p[f"{key}.to_q.weight"])
        kv = ops.linear(context, p[f"{key}.to_kv.weight"])
        out = ops.attention_kv(q, kv, num_heads=num_heads)
    else:
        q = ops.linear(x, p[f"{key}.to_q.weight"])
        k = ops.linear(context, p[f"{key}.to_k.weight"])
        v = ops.linear(context, p[f"{key}.to_v.weight"])
        out = ops.attention(q, k, v, num_heads=num_heads)
    return ops.linear(out, p[f"{key}.to_out.0.weight"], p[f"{key}.to_out.0.bias"])


def _feed_forward(p, key: str, x):
    """GEGLU feed-forward: proj -> split -> state*gelu(gate) -> linear.

    Reference: fuse_geglu pass + geglu kernel (``replace_geglu.py:34-39``,
    ``kernels/geglu.py``). Dropout between GEGLU and the out-projection is
    elided entirely (the remove_dropout pass analog: inference never has it).
    """
    proj = ops.linear(x, p[f"{key}.net.0.proj.weight"], p[f"{key}.net.0.proj.bias"])
    state, gate = jnp.split(proj, 2, axis=-1)
    h = ops.geglu(state, gate)
    return ops.linear(h, p[f"{key}.net.2.weight"], p[f"{key}.net.2.bias"])


def _transformer_block(p, key: str, x, context, num_heads: int, eps: float,
                       cross_kv=None):
    h = ops.layer_norm(x, p[f"{key}.norm1.weight"], p[f"{key}.norm1.bias"], eps=eps)
    x = x + _attention_layer(p, f"{key}.attn1", h, h, num_heads)
    h = ops.layer_norm(x, p[f"{key}.norm2.weight"], p[f"{key}.norm2.bias"], eps=eps)
    cached = None if cross_kv is None else cross_kv.get(f"{key}.attn2")
    if cached is None and context is None:
        raise KeyError(f"cross_kv is missing {key}.attn2 and no context given")
    x = x + _attention_layer(p, f"{key}.attn2", h, context, num_heads,
                             cached_kv=cached)
    h = ops.layer_norm(x, p[f"{key}.norm3.weight"], p[f"{key}.norm3.bias"], eps=eps)
    return x + _feed_forward(p, f"{key}.ff", h)


def _transformer2d(p, key: str, x, context, cfg: UNetConfig, layers: int,
                   cross_kv=None):
    """Transformer2DModel with linear projections (SDXL uses use_linear_projection)."""
    n, h, w, c = x.shape
    num_heads = cfg.num_heads(c)
    residual = x
    hs = ops.group_norm(
        x, p[f"{key}.norm.weight"], p[f"{key}.norm.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.transformer_norm_eps,
    )
    hs = hs.reshape(n, h * w, c)
    hs = ops.linear(hs, p[f"{key}.proj_in.weight"], p[f"{key}.proj_in.bias"])
    for k in range(layers):
        hs = _transformer_block(
            p, f"{key}.transformer_blocks.{k}", hs, context, num_heads,
            cfg.transformer_norm_eps, cross_kv=cross_kv,
        )
    hs = ops.linear(hs, p[f"{key}.proj_out.weight"], p[f"{key}.proj_out.bias"])
    return hs.reshape(n, h, w, c) + residual


def _downsample(p, key: str, x):
    return ops.conv2d(x, p[f"{key}.conv.weight"], p[f"{key}.conv.bias"], stride=2, padding=1)


def _upsample(p, key: str, x):
    n, h, w, c = x.shape
    # nearest-neighbor 2x (broadcast, no gather — XLA lowers this to a cheap reshape)
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (n, h, 2, w, 2, c))
    x = x.reshape(n, h * 2, w * 2, c)
    return ops.conv2d(x, p[f"{key}.conv.weight"], p[f"{key}.conv.bias"])


def _time_embedding(cfg: UNetConfig, p, timesteps, text_embeds, time_ids, dtype):
    """Time + added (text_time) conditioning -> temb (B, time_embed_dim).

    Reference ``unet_pt.py:469-488``: sinusoidal t embedding through the
    2-layer time MLP, plus (SDXL) the pooled-text + fourier(time_ids)
    add_embedding MLP."""
    batch = timesteps.shape[0]
    temb = ops.time_embed(
        timesteps, dim=cfg.block_out_channels[0],
        flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
    ).astype(dtype)
    temb = ops.linear(temb, p["time_embedding.linear_1.weight"], p["time_embedding.linear_1.bias"])
    temb = ops.linear(
        jax.nn.silu(temb), p["time_embedding.linear_2.weight"], p["time_embedding.linear_2.bias"]
    )

    if cfg.has_addition_embedding:
        if text_embeds.shape[-1] == cfg.projection_class_embeddings_input_dim \
                and time_ids.shape[-1] == 0:
            # SGM/ComfyUI convention: the caller already built the full
            # add-embedding input y = concat(pooled, fourier(time_ids))
            # (same [cos, sin] fourier layout as diffusers' add_time_proj)
            add = text_embeds.astype(dtype)
        else:
            tids = ops.time_embed(
                time_ids.reshape(-1), dim=cfg.addition_time_embed_dim,
                flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
            ).astype(dtype)
            tids = tids.reshape(batch, -1)
            add = jnp.concatenate([text_embeds.astype(dtype), tids], axis=-1)
        add = ops.linear(add, p["add_embedding.linear_1.weight"], p["add_embedding.linear_1.bias"])
        add = ops.linear(
            jax.nn.silu(add), p["add_embedding.linear_2.weight"], p["add_embedding.linear_2.bias"]
        )
        temb = temb + add
    return temb


def resnet_keys(cfg: UNetConfig) -> list[str]:
    """Every ResnetBlock2D key prefix, in forward order."""
    out: list[str] = []
    for i in range(len(cfg.down_block_types)):
        for j in range(cfg.layers_per_block):
            out.append(f"down_blocks.{i}.resnets.{j}")
    out += ["mid_block.resnets.0", "mid_block.resnets.1"]
    for i in range(len(cfg.up_block_types)):
        for j in range(cfg.layers_per_block + 1):
            out.append(f"up_blocks.{i}.resnets.{j}")
    return out


def precompute_time_cond(
    cfg: UNetConfig,
    params: dict[str, jax.Array],
    timesteps: jax.Array,      # (T,) one scalar timestep per denoise step
    text_embeds: jax.Array,    # (B, pooled) CFG-doubled conditioning
    time_ids: jax.Array,       # (B, 6)
    dtype=None,
) -> dict[str, jax.Array]:
    """Batch every timestep-conditioned projection over all T steps at once.

    Per step the UNet runs ~27 tiny latency-bound GEMMs off the time embedding
    (the 2-layer time MLP, the add_embedding MLP, and one (temb_dim, C)
    ``time_emb_proj`` per resnet, ~50 MB of weights re-read per step for
    SDXL-base). All of it depends only on (t, text_embeds, time_ids), so one
    (T*B)-row batch before the scan replaces T repetitions. Returns
    {resnet_key: (T, B, C)}; slice step i's {resnet_key: (B, C)} into
    ``unet_apply(time_cond=...)`` (lax.scan's xs slicing does this for free).
    """
    if dtype is None:
        dtype = text_embeds.dtype
    t_steps = timesteps.shape[0]
    batch = text_embeds.shape[0]
    ts_all = jnp.repeat(timesteps, batch)                      # (T*B,)
    te_all = jnp.tile(text_embeds, (t_steps, 1))
    tid_all = jnp.tile(time_ids, (t_steps, 1))
    temb = _time_embedding(cfg, params, ts_all, te_all, tid_all, dtype)
    s = jax.nn.silu(temb)
    cache = {}
    for key in resnet_keys(cfg):
        emb = ops.linear(
            s, params[f"{key}.time_emb_proj.weight"], params[f"{key}.time_emb_proj.bias"]
        )
        cache[key] = emb.reshape(t_steps, batch, -1)
    return cache


def transformer2d_keys(cfg: UNetConfig) -> list[tuple[str, int]]:
    """Every Transformer2DModel key prefix and its depth, in forward order."""
    out: list[tuple[str, int]] = []
    for i, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            for j in range(cfg.layers_per_block):
                out.append((f"down_blocks.{i}.attentions.{j}",
                            cfg.transformer_layers_per_block[i]))
    out.append(("mid_block.attentions.0", cfg.mid_transformer_layers))
    for i, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            depth = tuple(reversed(cfg.transformer_layers_per_block))[i]
            for j in range(cfg.layers_per_block + 1):
                out.append((f"up_blocks.{i}.attentions.{j}", depth))
    return out


def precompute_cross_kv(
    cfg: UNetConfig,
    params: dict[str, jax.Array],
    encoder_hidden_states: jax.Array,
) -> dict[str, jax.Array | tuple[jax.Array, jax.Array]]:
    """Project the text conditioning through every cross-attention K/V once.

    The encoder hidden states are constant across all denoise steps, so these
    projections are loop-invariant: hoisting them out of the scan removes
    ~680 MB/step of K/V weight traffic plus ~70 latency-bound (B*77, ctx_dim)
    GEMM dispatches (SDXL-base). Values are bit-identical to what
    ``unet_apply`` computes inline — the same ``ops.linear`` on the same
    dtype-cast context — so the cached step is numerically exact.

    Returns {"<tf2d key>.transformer_blocks.<k>.attn2": kv} where kv is the
    fused (B, Sk, 2C) projection when ``fuse_attention_projections`` ran, or
    a (k, v) tuple for unfused params. Feed to ``unet_apply(cross_kv=...)``.
    """
    ctx = encoder_hidden_states
    cache: dict[str, jax.Array | tuple[jax.Array, jax.Array]] = {}
    for tf_key, depth in transformer2d_keys(cfg):
        for k in range(depth):
            key = f"{tf_key}.transformer_blocks.{k}.attn2"
            if f"{key}.to_kv.weight" in params:
                cache[key] = ops.linear(ctx, params[f"{key}.to_kv.weight"])
            else:
                cache[key] = (
                    ops.linear(ctx, params[f"{key}.to_k.weight"]),
                    ops.linear(ctx, params[f"{key}.to_v.weight"]),
                )
    return cache


def unet_apply(
    cfg: UNetConfig,
    params: dict[str, jax.Array],
    sample: jax.Array,
    timesteps: jax.Array,
    encoder_hidden_states: jax.Array,
    text_embeds: jax.Array,
    time_ids: jax.Array,
    cross_kv: dict | None = None,
    time_cond: dict | None = None,
    return_cache: bool = False,
    cache_depth: int = 1,
) -> jax.Array:
    """One denoising forward pass.

    sample: (B, H, W, C_in) NHWC latents; timesteps: (B,) or scalar;
    encoder_hidden_states: (B, S, cross_attention_dim); text_embeds: (B, pooled);
    time_ids: (B, 6). Returns predicted noise, same shape as sample.
    ``cross_kv`` (optional): precomputed cross-attention K/V projections from
    ``precompute_cross_kv`` — step-invariant work hoisted out of the denoise
    loop; numerically identical to recomputing them here. ``time_cond``
    (optional): this step's {resnet_key: (B, C)} time_emb_proj slice from
    ``precompute_time_cond`` — same hoisting idea for the per-step
    time-conditioning GEMMs.

    ``return_cache``: also return the hidden state entering up block
    ``len(up) - cache_depth`` (right after the preceding upsample) — the
    DeepCache split point (Ma et al. 2023): everything *below* the outermost
    ``cache_depth`` levels feeds the rest of the UNet only through this one
    tensor, so a later step can reuse it and recompute just the shallow
    levels (``unet_apply_shallow``). Returns ``(eps, cache)``.

    I/O shape contract matches the reference benchmark driver
    (``implementations/Diffusers/load_unet.py:28-34``) modulo NCHW->NHWC.
    """
    p = params
    dtype = sample.dtype
    if timesteps.ndim == 0:
        timesteps = jnp.broadcast_to(timesteps, (sample.shape[0],))

    temb = (None if time_cond is not None
            else _time_embedding(cfg, p, timesteps, text_embeds, time_ids, dtype))

    if encoder_hidden_states is None:
        # every cross-attention must then hit the precomputed cache
        assert cross_kv is not None, "need encoder_hidden_states or cross_kv"
        ctx = None
    else:
        ctx = encoder_hidden_states.astype(dtype)

    # --- down path ---
    h = ops.conv2d(sample, p["conv_in.weight"], p["conv_in.bias"])
    skips = [h]
    for i, btype in enumerate(cfg.down_block_types):
        for j in range(cfg.layers_per_block):
            rk = f"down_blocks.{i}.resnets.{j}"
            h = _resnet(p, rk, h, temb, cfg,
                        emb=None if time_cond is None else time_cond[rk])
            if btype == "CrossAttnDownBlock2D":
                h = _transformer2d(
                    p, f"down_blocks.{i}.attentions.{j}", h, ctx, cfg,
                    cfg.transformer_layers_per_block[i], cross_kv=cross_kv,
                )
            skips.append(h)
        if i < len(cfg.down_block_types) - 1:
            h = _downsample(p, f"down_blocks.{i}.downsamplers.0", h)
            skips.append(h)

    # --- mid ---
    h = _resnet(p, "mid_block.resnets.0", h, temb, cfg,
                emb=None if time_cond is None else time_cond["mid_block.resnets.0"])
    h = _transformer2d(
        p, "mid_block.attentions.0", h, ctx, cfg, cfg.mid_transformer_layers,
        cross_kv=cross_kv,
    )
    h = _resnet(p, "mid_block.resnets.1", h, temb, cfg,
                emb=None if time_cond is None else time_cond["mid_block.resnets.1"])

    # --- up path ---
    cache = None
    for i, btype in enumerate(cfg.up_block_types):
        if return_cache and i == len(cfg.up_block_types) - cache_depth:
            cache = h  # the DeepCache split point (see docstring)
        tf_layers = tuple(reversed(cfg.transformer_layers_per_block))[i]
        for j in range(cfg.layers_per_block + 1):
            h = jnp.concatenate([h, skips.pop()], axis=-1)
            rk = f"up_blocks.{i}.resnets.{j}"
            h = _resnet(p, rk, h, temb, cfg,
                        emb=None if time_cond is None else time_cond[rk])
            if btype == "CrossAttnUpBlock2D":
                h = _transformer2d(p, f"up_blocks.{i}.attentions.{j}", h, ctx,
                                   cfg, tf_layers, cross_kv=cross_kv)
        if i < len(cfg.up_block_types) - 1:
            h = _upsample(p, f"up_blocks.{i}.upsamplers.0", h)

    # --- out ---
    out = ops.gn_conv2d(
        h, p["conv_norm_out.weight"], p["conv_norm_out.bias"],
        p["conv_out.weight"], p["conv_out.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, gn_act="silu",
    )
    return (out, cache) if return_cache else out


def deep_cache_shape(cfg: UNetConfig, batch: int, lat_h: int, lat_w: int,
                     cache_depth: int = 1) -> tuple[int, int, int, int]:
    """Static shape of the DeepCache feature for a (batch, lat_h, lat_w)
    latent: it enters up block ``len(up) - cache_depth``, i.e. the output of
    the previous up block after its upsample — ``block_out_channels[depth]``
    channels at ``2^(depth-1)``-downsampled resolution."""
    if not 1 <= cache_depth < len(cfg.block_out_channels):
        raise ValueError(
            f"deep_cache depth must be in [1, {len(cfg.block_out_channels) - 1}] "
            f"for this {len(cfg.block_out_channels)}-level UNet, got "
            f"{cache_depth}"
        )
    s = cache_depth - 1
    return (batch, lat_h >> s, lat_w >> s, cfg.block_out_channels[cache_depth])


def unet_apply_shallow(
    cfg: UNetConfig,
    params: dict[str, jax.Array],
    sample: jax.Array,
    timesteps: jax.Array,
    encoder_hidden_states: jax.Array,
    text_embeds: jax.Array,
    time_ids: jax.Array,
    cache: jax.Array,
    cross_kv: dict | None = None,
    time_cond: dict | None = None,
    cache_depth: int = 1,
) -> jax.Array:
    """DeepCache fast pass: recompute only the outermost ``cache_depth``
    levels, splicing ``cache`` (from ``unet_apply(..., return_cache=True)``)
    in place of everything deeper.

    Runs conv_in + down blocks ``[0, cache_depth)`` (for their skip
    connections), then resumes the up path at block ``len(up) - cache_depth``
    from ``cache``. With ``cache`` captured from a full pass on identical
    inputs this is bit-identical to that pass's output (the shallow levels
    see exactly the same operands — parity-tested); across steps it is the
    DeepCache approximation: the deep features drift slowly in t, the shallow
    ones carry the per-step detail. For SDXL (depth 1) the fast pass is
    attention-free — ~20x less work than a full step.
    """
    p = params
    dtype = sample.dtype
    if timesteps.ndim == 0:
        timesteps = jnp.broadcast_to(timesteps, (sample.shape[0],))

    temb = (None if time_cond is not None
            else _time_embedding(cfg, p, timesteps, text_embeds, time_ids, dtype))
    if encoder_hidden_states is None:
        assert cross_kv is not None, "need encoder_hidden_states or cross_kv"
        ctx = None
    else:
        ctx = encoder_hidden_states.astype(dtype)

    h = ops.conv2d(sample, p["conv_in.weight"], p["conv_in.bias"])
    skips = [h]
    for i in range(cache_depth):
        btype = cfg.down_block_types[i]
        for j in range(cfg.layers_per_block):
            rk = f"down_blocks.{i}.resnets.{j}"
            h = _resnet(p, rk, h, temb, cfg,
                        emb=None if time_cond is None else time_cond[rk])
            if btype == "CrossAttnDownBlock2D":
                h = _transformer2d(
                    p, f"down_blocks.{i}.attentions.{j}", h, ctx, cfg,
                    cfg.transformer_layers_per_block[i], cross_kv=cross_kv,
                )
            skips.append(h)
        if i < cache_depth - 1:
            h = _downsample(p, f"down_blocks.{i}.downsamplers.0", h)
            skips.append(h)

    h = cache.astype(dtype)
    n = len(cfg.up_block_types)
    for i in range(n - cache_depth, n):
        btype = cfg.up_block_types[i]
        tf_layers = tuple(reversed(cfg.transformer_layers_per_block))[i]
        for j in range(cfg.layers_per_block + 1):
            h = jnp.concatenate([h, skips.pop()], axis=-1)
            rk = f"up_blocks.{i}.resnets.{j}"
            h = _resnet(p, rk, h, temb, cfg,
                        emb=None if time_cond is None else time_cond[rk])
            if btype == "CrossAttnUpBlock2D":
                h = _transformer2d(p, f"up_blocks.{i}.attentions.{j}", h, ctx,
                                   cfg, tf_layers, cross_kv=cross_kv)
        if i < n - 1:
            h = _upsample(p, f"up_blocks.{i}.upsamplers.0", h)

    return ops.gn_conv2d(
        h, p["conv_norm_out.weight"], p["conv_norm_out.bias"],
        p["conv_out.weight"], p["conv_out.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, gn_act="silu",
    )
