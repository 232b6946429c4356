"""VAE cross-validation against an independent torch implementation.

The UNet and CLIP both have non-repo numeric oracles (the reference's own
torch UNet, HF transformers); this gives the VAE one too. The oracle below is
an independent torch re-implementation of diffusers' AutoencoderKL
decoder/encoder semantics (ResnetBlock2D, single-head mid attention with
1/sqrt(C) scale, nearest-x2 upsample, asymmetric-pad stride-2 downsample)
with exact HF module naming, so ``io.torch_ingest.state_dict_to_params``
ingests its weights the same way it ingests a real checkpoint. Any
divergence in VAE math (not just shapes), weight layout/transposes, or
block wiring fails these tests.

Runs on CPU (fp32 both sides) on the tiny VAE config — a couple seconds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from stabletriton_jax import ops  # noqa: E402
from stabletriton_jax.io.safetensors_io import validate_against_shapes  # noqa: E402
from stabletriton_jax.io.torch_ingest import state_dict_to_params  # noqa: E402
from stabletriton_jax.models.vae import (  # noqa: E402
    tiny_vae_config,
    vae_decode,
    vae_decoder_param_shapes,
    vae_encode,
    vae_encoder_param_shapes,
)


class _Resnet(nn.Module):
    def __init__(self, cin, cout, groups, eps):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(cin, cout, 1) if cin != cout else None
        )

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + skip


class _MidAttention(nn.Module):
    """diffusers VAE mid attention: GN -> 1-head SDPA over the HW grid -> out
    projection -> +residual."""

    def __init__(self, c, groups, eps):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=eps)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        n, c, h, w = x.shape
        hs = self.group_norm(x).reshape(n, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(hs), self.to_k(hs), self.to_v(hs)
        out = F.scaled_dot_product_attention(
            q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1)
        ).squeeze(1)
        out = self.to_out[0](out)
        return out.transpose(1, 2).reshape(n, c, h, w) + x


class _Upsampler(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Downsampler(nn.Module):
    """HF VAE downsample: asymmetric (0,1)x(0,1) pad + stride-2 valid conv."""

    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Mid(nn.Module):
    def __init__(self, c, groups, eps):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_Resnet(c, c, groups, eps), _Resnet(c, c, groups, eps)]
        )
        self.attentions = nn.ModuleList([_MidAttention(c, groups, eps)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _UpBlock(nn.Module):
    def __init__(self, cin, cout, n_res, groups, eps, upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_Resnet(cin if j == 0 else cout, cout, groups, eps)
             for j in range(n_res)]
        )
        self.upsamplers = nn.ModuleList([_Upsampler(cout)] if upsample else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for u in self.upsamplers:
            x = u(x)
        return x


class _DownBlock(nn.Module):
    def __init__(self, cin, cout, n_res, groups, eps, downsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_Resnet(cin if j == 0 else cout, cout, groups, eps)
             for j in range(n_res)]
        )
        self.downsamplers = nn.ModuleList(
            [_Downsampler(cout)] if downsample else []
        )

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for d in self.downsamplers:
            x = d(x)
        return x


class _Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        top = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, top, 3, padding=1)
        self.mid_block = _Mid(top, g, eps)
        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        prev = top
        for i, cout in enumerate(rev):
            self.up_blocks.append(_UpBlock(
                prev, cout, cfg.layers_per_block + 1, g, eps,
                upsample=i < len(rev) - 1,
            ))
            prev = cout
        self.conv_norm_out = nn.GroupNorm(g, cfg.block_out_channels[0], eps=eps)
        self.conv_out = nn.Conv2d(
            cfg.block_out_channels[0], cfg.out_channels, 3, padding=1
        )

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for b in self.up_blocks:
            h = b(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.out_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, cout in enumerate(ch):
            self.down_blocks.append(_DownBlock(
                prev, cout, cfg.layers_per_block, g, eps,
                downsample=i < len(ch) - 1,
            ))
            prev = cout
        self.mid_block = _Mid(ch[-1], g, eps)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=eps)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for b in self.down_blocks:
            h = b(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _TorchVAE(nn.Module):
    """Root module so state_dict keys carry the HF 'decoder.*'/'encoder.*'/
    'post_quant_conv.*'/'quant_conv.*' prefixes exactly."""

    def __init__(self, cfg):
        super().__init__()
        lc = cfg.latent_channels
        self.decoder = _Decoder(cfg)
        self.encoder = _Encoder(cfg)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)

    def decode(self, scaled_latents, scaling):
        return self.decoder(self.post_quant_conv(scaled_latents / scaling))

    def encode_mean(self, images, scaling):
        moments = self.quant_conv(self.encoder(images))
        mean, _ = torch.chunk(moments, 2, dim=1)
        return mean * scaling


@pytest.fixture(scope="module")
def oracle_and_params():
    cfg = tiny_vae_config()
    torch.manual_seed(7)
    with torch.no_grad():
        oracle = _TorchVAE(cfg).eval()
        for p in oracle.parameters():
            p.mul_(0.4)  # damp random init so activations stay O(1)
    params = {
        k: jnp.asarray(v)
        for k, v in state_dict_to_params(oracle, dtype=np.float32).items()
    }
    return cfg, oracle, params


def test_vae_decoder_matches_torch_oracle(oracle_and_params):
    cfg, oracle, params = oracle_and_params
    dec = {k: v for k, v in params.items()
           if k.startswith(("decoder.", "post_quant_conv."))}
    validate_against_shapes(
        {k: np.asarray(v) for k, v in dec.items()},
        vae_decoder_param_shapes(cfg),
    )
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    with torch.no_grad():
        want = oracle.decode(torch.from_numpy(lat), cfg.scaling_factor)
    got = vae_decode(cfg, dec, jnp.asarray(lat.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(
        np.asarray(got).transpose(0, 3, 1, 2), want.numpy(), atol=1e-4
    )
    # and through the GPU attention binding (the fp32 decoder keeps its
    # XLA path there)
    with ops.use_backends({"attention": "cudnn"}):
        got_p = vae_decode(cfg, dec, jnp.asarray(lat.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(
        np.asarray(got_p).transpose(0, 3, 1, 2), want.numpy(), atol=1e-3
    )


def test_vae_encoder_matches_torch_oracle(oracle_and_params):
    cfg, oracle, params = oracle_and_params
    enc = {k: v for k, v in params.items()
           if k.startswith(("encoder.", "quant_conv."))}
    validate_against_shapes(
        {k: np.asarray(v) for k, v in enc.items()},
        vae_encoder_param_shapes(cfg),
    )
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        want = oracle.encode_mean(torch.from_numpy(img), cfg.scaling_factor)
    got = vae_encode(cfg, enc, jnp.asarray(img.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(
        np.asarray(got).transpose(0, 3, 1, 2), want.numpy(), atol=1e-4
    )
