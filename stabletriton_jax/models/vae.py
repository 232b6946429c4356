"""Functional VAE (AutoencoderKL) decoder — latents -> RGB.

The reference ran VAE decode as eager torch outside its optimization envelope
(SURVEY.md §3.4); here it is a jitted functional model so the whole txt2img
program stays on-device. Params are a flat {hf_state_dict_key: array} dict
(conv HWIO, linear (in,out)) matching diffusers' AutoencoderKL "decoder.*" /
"post_quant_conv.*" keys. NHWC activations.

The mid-block single-head attention over the full latent grid (S = H·W) routes
through ops.attention. Its head dim (512) and the decoder's fp32 are outside
what cuDNN's flash attention takes, so it runs the plain XLA composition
(ops/gpu.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from stabletriton_jax import ops


@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    out_channels: int = 3
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.13025  # SDXL VAE

    @property
    def spatial_scale_factor(self) -> int:
        """Pixels per latent cell (8 for the 4-level SDXL VAE)."""
        return 2 ** (len(self.block_out_channels) - 1)


def sdxl_vae_config() -> VAEConfig:
    return VAEConfig()


def sd15_vae_config() -> VAEConfig:
    """SD1.x/2.x AutoencoderKL: same topology, 0.18215 scaling."""
    return VAEConfig(scaling_factor=0.18215)


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(8, 16), norm_num_groups=4, layers_per_block=1)


class _B:
    def __init__(self):
        self.shapes: dict[str, tuple[int, ...]] = {}

    def conv(self, key, cin, cout, k=3):
        self.shapes[f"{key}.weight"] = (k, k, cin, cout)
        self.shapes[f"{key}.bias"] = (cout,)

    def norm(self, key, c):
        self.shapes[f"{key}.weight"] = (c,)
        self.shapes[f"{key}.bias"] = (c,)

    def linear(self, key, cin, cout):
        self.shapes[f"{key}.weight"] = (cin, cout)
        self.shapes[f"{key}.bias"] = (cout,)


def _resnet_shapes(b: _B, key, cin, cout):
    b.norm(f"{key}.norm1", cin)
    b.conv(f"{key}.conv1", cin, cout)
    b.norm(f"{key}.norm2", cout)
    b.conv(f"{key}.conv2", cout, cout)
    if cin != cout:
        b.conv(f"{key}.conv_shortcut", cin, cout, k=1)


def vae_decoder_param_shapes(cfg: VAEConfig) -> dict[str, tuple[int, ...]]:
    b = _B()
    top = cfg.block_out_channels[-1]
    b.conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, k=1)
    b.conv("decoder.conv_in", cfg.latent_channels, top)
    _resnet_shapes(b, "decoder.mid_block.resnets.0", top, top)
    b.norm("decoder.mid_block.attentions.0.group_norm", top)
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        b.linear(f"decoder.mid_block.attentions.0.{proj}", top, top)
    _resnet_shapes(b, "decoder.mid_block.resnets.1", top, top)

    rev = list(reversed(cfg.block_out_channels))  # e.g. [512, 512, 256, 128]
    prev = top
    for i, cout in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            _resnet_shapes(b, f"decoder.up_blocks.{i}.resnets.{j}", prev, cout)
            prev = cout
        if i < len(rev) - 1:
            b.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", cout, cout)
    b.norm("decoder.conv_norm_out", cfg.block_out_channels[0])
    b.conv("decoder.conv_out", cfg.block_out_channels[0], cfg.out_channels)
    return b.shapes


def init_vae_params(cfg: VAEConfig, rng: jax.Array | int = 0, dtype=jnp.float32):
    if isinstance(rng, int):
        rng = jax.random.PRNGKey(rng)
    shapes = vae_decoder_param_shapes(cfg)
    out = {}
    keys = jax.random.split(rng, len(shapes))
    for k, (name, shape) in zip(keys, sorted(shapes.items())):
        if name.endswith(".bias"):
            out[name] = jnp.zeros(shape, dtype)
        elif ".norm" in name or "group_norm" in name:
            out[name] = jnp.ones(shape, dtype)
        else:
            fan = int(np.prod(shape[:-1]))
            out[name] = (
                jax.random.normal(k, shape, jnp.float32) / np.sqrt(max(fan, 1))
            ).astype(dtype)
    return out


def _resnet(p, key, x, cfg: VAEConfig):
    h = ops.group_norm(
        x, p[f"{key}.norm1.weight"], p[f"{key}.norm1.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu",
    )
    h = ops.conv2d(h, p[f"{key}.conv1.weight"], p[f"{key}.conv1.bias"])
    h = ops.group_norm(
        h, p[f"{key}.norm2.weight"], p[f"{key}.norm2.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu",
    )
    if f"{key}.conv_shortcut.weight" in p:
        skip = ops.conv2d(x, p[f"{key}.conv_shortcut.weight"],
                          p[f"{key}.conv_shortcut.bias"], padding=0)
    else:
        skip = x
    return ops.conv2d(h, p[f"{key}.conv2.weight"], p[f"{key}.conv2.bias"], residual=skip)


def _mid_attention(p, key, x, cfg: VAEConfig):
    n, h, w, c = x.shape
    res = x
    hs = ops.group_norm(
        x, p[f"{key}.group_norm.weight"], p[f"{key}.group_norm.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
    )
    hs = hs.reshape(n, h * w, c)
    q = ops.linear(hs, p[f"{key}.to_q.weight"], p[f"{key}.to_q.bias"])
    k = ops.linear(hs, p[f"{key}.to_k.weight"], p[f"{key}.to_k.bias"])
    v = ops.linear(hs, p[f"{key}.to_v.weight"], p[f"{key}.to_v.bias"])
    out = ops.attention(q, k, v, num_heads=1)
    out = ops.linear(out, p[f"{key}.to_out.0.weight"], p[f"{key}.to_out.0.bias"])
    return out.reshape(n, h, w, c) + res


def _upsample(p, key, x):
    n, h, w, c = x.shape
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (n, h, 2, w, 2, c))
    x = x.reshape(n, h * 2, w * 2, c)
    return ops.conv2d(x, p[f"{key}.conv.weight"], p[f"{key}.conv.bias"])


def vae_encoder_param_shapes(cfg: VAEConfig) -> dict[str, tuple[int, ...]]:
    """Encoder-side table (HF "encoder.*" / "quant_conv.*" keys).

    The encoder enables true image->image (the reference had no image input
    path at all): RGB -> posterior moments -> sampled, scaled latents.
    """
    b = _B()
    ch0 = cfg.block_out_channels[0]
    top = cfg.block_out_channels[-1]
    b.conv("encoder.conv_in", cfg.out_channels, ch0)
    prev = ch0
    for i, cout in enumerate(cfg.block_out_channels):
        for j in range(cfg.layers_per_block):
            _resnet_shapes(b, f"encoder.down_blocks.{i}.resnets.{j}", prev, cout)
            prev = cout
        if i < len(cfg.block_out_channels) - 1:
            b.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", cout, cout)
    _resnet_shapes(b, "encoder.mid_block.resnets.0", top, top)
    b.norm("encoder.mid_block.attentions.0.group_norm", top)
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        b.linear(f"encoder.mid_block.attentions.0.{proj}", top, top)
    _resnet_shapes(b, "encoder.mid_block.resnets.1", top, top)
    b.norm("encoder.conv_norm_out", top)
    b.conv("encoder.conv_out", top, 2 * cfg.latent_channels)
    b.conv("quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)
    return b.shapes


def init_vae_encoder_params(cfg: VAEConfig, rng: jax.Array | int = 0, dtype=jnp.float32):
    if isinstance(rng, int):
        rng = jax.random.PRNGKey(rng)
    shapes = vae_encoder_param_shapes(cfg)
    out = {}
    keys = jax.random.split(rng, len(shapes))
    for k, (name, shape) in zip(keys, sorted(shapes.items())):
        if name.endswith(".bias"):
            out[name] = jnp.zeros(shape, dtype)
        elif ".norm" in name or "group_norm" in name:
            out[name] = jnp.ones(shape, dtype)
        else:
            fan = int(np.prod(shape[:-1]))
            out[name] = (
                jax.random.normal(k, shape, jnp.float32) / np.sqrt(max(fan, 1))
            ).astype(dtype)
    return out


def vae_encode(
    cfg: VAEConfig,
    params: dict[str, jax.Array],
    images: jax.Array,
    *,
    rng: jax.Array | None = None,
):
    """images (B, H, W, 3) in [-1, 1] -> scaled latents (B, H/8, W/8, 4).

    Deterministic (posterior mean) when rng is None; sampled otherwise.
    """
    p = params
    h = ops.conv2d(images, p["encoder.conv_in.weight"], p["encoder.conv_in.bias"])
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block):
            h = _resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", h, cfg)
        if i < len(cfg.block_out_channels) - 1:
            # HF VAE downsample: asymmetric (0,1)x(0,1) pad + stride-2 valid conv
            h = ops.conv2d(
                h, p[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"],
                p[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"],
                stride=2, padding=((0, 1), (0, 1)),
            )
    h = _resnet(p, "encoder.mid_block.resnets.0", h, cfg)
    h = _mid_attention(p, "encoder.mid_block.attentions.0", h, cfg)
    h = _resnet(p, "encoder.mid_block.resnets.1", h, cfg)
    h = ops.group_norm(
        h, p["encoder.conv_norm_out.weight"], p["encoder.conv_norm_out.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu",
    )
    h = ops.conv2d(h, p["encoder.conv_out.weight"], p["encoder.conv_out.bias"])
    h = ops.conv2d(h, p["quant_conv.weight"], p["quant_conv.bias"], padding=0)
    mean, logvar = jnp.split(h, 2, axis=-1)
    if rng is not None:
        std = jnp.exp(0.5 * jnp.clip(logvar, -30.0, 20.0))
        mean = mean + std * jax.random.normal(rng, mean.shape, mean.dtype)
    return mean * cfg.scaling_factor


def vae_decode(cfg: VAEConfig, params: dict[str, jax.Array], latents: jax.Array):
    """latents: (B, h, w, 4) *scaled* latents (as produced by the denoiser).
    Returns RGB images in [-1, 1], (B, 8h, 8w, 3)."""
    p = params
    z = latents / cfg.scaling_factor
    z = ops.conv2d(z, p["post_quant_conv.weight"], p["post_quant_conv.bias"], padding=0)
    h = ops.conv2d(z, p["decoder.conv_in.weight"], p["decoder.conv_in.bias"])
    h = _resnet(p, "decoder.mid_block.resnets.0", h, cfg)
    h = _mid_attention(p, "decoder.mid_block.attentions.0", h, cfg)
    h = _resnet(p, "decoder.mid_block.resnets.1", h, cfg)
    rev = list(reversed(cfg.block_out_channels))
    for i in range(len(rev)):
        for j in range(cfg.layers_per_block + 1):
            h = _resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", h, cfg)
        if i < len(rev) - 1:
            h = _upsample(p, f"decoder.up_blocks.{i}.upsamplers.0", h)
    h = ops.group_norm(
        h, p["decoder.conv_norm_out.weight"], p["decoder.conv_norm_out.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu",
    )
    return ops.conv2d(h, p["decoder.conv_out.weight"], p["decoder.conv_out.bias"])
