"""Assemble a full SDXLPipeline from a Diffusers-layout checkpoint directory.

Expected layout (what ``StableDiffusionXLPipeline.save_pretrained`` writes and
every SDXL distribution mirrors — the reference pulled the same files through
``DiffusionPipeline.from_pretrained`` + torch, SURVEY.md §5 "Checkpoint"):

    root/
      unet/diffusion_pytorch_model.safetensors        (+ config.json)
      vae/diffusion_pytorch_model.safetensors
      text_encoder/model.safetensors
      text_encoder_2/model.safetensors
      tokenizer/{vocab.json, merges.txt}
      tokenizer_2/{vocab.json, merges.txt}

Multi-shard checkpoints (model-00001-of-0000N.safetensors) are concatenated.
Everything loads torch-free through the native safetensors reader.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from stabletriton_jax.compile import CompileConfig
from stabletriton_jax.io.safetensors_io import (
    convert_state_dict,
    read_safetensors,
    validate_against_shapes,
)
from stabletriton_jax.io.tokenizer import CLIPTokenizer
from stabletriton_jax.models import clip as clip_mod
from stabletriton_jax.models import vae as vae_mod
from stabletriton_jax.models.unet import UNetConfig, unet_param_shapes


def _read_component(comp_dir: Path) -> dict[str, np.ndarray]:
    files = sorted(comp_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {comp_dir}")
    sd: dict[str, np.ndarray] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return sd


def load_component(comp_dir: str | Path, *, dtype=None,
                   expected: dict | None = None) -> dict[str, np.ndarray]:
    params = convert_state_dict(_read_component(Path(comp_dir)), dtype=dtype)
    if expected is not None:
        validate_against_shapes(params, expected)
    return params


def unet_config_from_json(config_path: Path) -> UNetConfig:
    from stabletriton_jax.io.torch_ingest import unet_config_from_diffusers

    return unet_config_from_diffusers(json.loads(config_path.read_text()))


def load_sdxl(
    root: str | Path,
    *,
    compile_config: CompileConfig | None = None,
    dtype=np.float32,
    validate: bool = True,
):
    """Returns (SDXLPipeline, tokenizer1, tokenizer2)."""
    from stabletriton_jax.runtime.pipeline import SDXLPipeline

    root = Path(root)
    ucfg_path = root / "unet" / "config.json"
    ucfg = unet_config_from_json(ucfg_path) if ucfg_path.exists() else UNetConfig()
    c1 = clip_mod.sdxl_text_encoder_config()
    c2 = clip_mod.sdxl_text_encoder_2_config()
    vcfg = vae_mod.sdxl_vae_config()

    import jax.numpy as jnp

    cc = compile_config or CompileConfig()

    def as_jnp(d, cast_dtype):
        return {k: jnp.asarray(v, cast_dtype) for k, v in d.items()}

    params = {
        "unet": as_jnp(
            load_component(
                root / "unet", dtype=dtype,
                expected=unet_param_shapes(ucfg) if validate else None,
            ),
            cc.jnp_dtype,
        ),
        # encoders + VAE run fp32 (fidelity; they are a tiny fraction of FLOPs)
        "text_encoder": as_jnp(load_component(root / "text_encoder", dtype=dtype), jnp.float32),
        "text_encoder_2": as_jnp(load_component(root / "text_encoder_2", dtype=dtype), jnp.float32),
        "vae": as_jnp(load_component(root / "vae", dtype=dtype), jnp.float32),
    }
    # VAE: keep only decoder-side tensors (encoder unused for txt2img)
    decoder_keys = set(vae_mod.vae_decoder_param_shapes(vcfg))
    params["vae"] = {k: v for k, v in params["vae"].items() if k in decoder_keys}

    pipe = SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg,
        params=params, compile_config=cc,
    )
    tok1 = CLIPTokenizer(root / "tokenizer" / "vocab.json",
                         root / "tokenizer" / "merges.txt")
    tok2 = CLIPTokenizer(root / "tokenizer_2" / "vocab.json",
                         root / "tokenizer_2" / "merges.txt")
    return pipe, tok1, tok2


def load_sdxl_single_file(
    checkpoint: str | Path,
    *,
    compile_config: CompileConfig | None = None,
    dtype=np.float32,
    tokenizer_dir: str | Path | None = None,
    validate: bool = True,
):
    """Build an SDXLPipeline from a monolithic SGM/A1111 .safetensors file.

    ``tokenizer_dir`` (optional): a directory with tokenizer/ and tokenizer_2/
    subdirs (single-file checkpoints do not embed vocabularies).
    Returns (pipeline, tok1 | None, tok2 | None).
    """
    import jax.numpy as jnp

    from stabletriton_jax.io.single_file import load_single_file
    from stabletriton_jax.models.unet import unet_param_shapes
    from stabletriton_jax.runtime.pipeline import SDXLPipeline

    ucfg = UNetConfig()
    c1 = clip_mod.sdxl_text_encoder_config()
    c2 = clip_mod.sdxl_text_encoder_2_config()
    vcfg = vae_mod.sdxl_vae_config()

    cc = compile_config or CompileConfig()
    raw = load_single_file(checkpoint, unet_config=ucfg, dtype=dtype)
    if validate:
        validate_against_shapes(raw["unet"], unet_param_shapes(ucfg))
    params = {
        "unet": {k: jnp.asarray(v, cc.jnp_dtype) for k, v in raw["unet"].items()},
        "text_encoder": {k: jnp.asarray(v, jnp.float32) for k, v in raw["text_encoder"].items()},
        "text_encoder_2": {k: jnp.asarray(v, jnp.float32) for k, v in raw["text_encoder_2"].items()},
        "vae": {k: jnp.asarray(v, jnp.float32) for k, v in raw["vae"].items()},
    }
    pipe = SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg,
        params=params, compile_config=cc,
    )
    tok1 = tok2 = None
    if tokenizer_dir is not None:
        tdir = Path(tokenizer_dir)
        tok1 = CLIPTokenizer(tdir / "tokenizer" / "vocab.json",
                             tdir / "tokenizer" / "merges.txt")
        tok2 = CLIPTokenizer(tdir / "tokenizer_2" / "vocab.json",
                             tdir / "tokenizer_2" / "merges.txt")
    return pipe, tok1, tok2


def load_single_file_auto(
    checkpoint: str | Path,
    *,
    compile_config: CompileConfig | None = None,
    dtype=np.float32,
    validate: bool = True,
):
    """Family-detecting single-file loader: SDXL, SD2.x or SD1.x.

    Returns (SDXLPipeline, family). SD2.x pipelines come back with
    clip_skip=2 (the SD2 convention).
    """
    import jax.numpy as jnp

    from stabletriton_jax.io.safetensors_io import read_safetensors
    from stabletriton_jax.io.single_file import detect_family, load_single_file
    from stabletriton_jax.models.unet import (
        sd15_unet_config,
        sd21_unet_config,
        unet_param_shapes,
    )
    from stabletriton_jax.runtime.pipeline import SDXLPipeline

    family = detect_family(read_safetensors(checkpoint))
    if family == "sdxl":
        pipe, _, _ = load_sdxl_single_file(
            checkpoint, compile_config=compile_config, dtype=dtype,
            validate=validate,
        )
        return pipe, family

    ucfg = sd15_unet_config() if family == "sd1" else sd21_unet_config()
    c1 = (clip_mod.sd15_text_encoder_config() if family == "sd1"
          else clip_mod.sd2_text_encoder_config())
    vcfg = vae_mod.sd15_vae_config()
    cc = compile_config or CompileConfig()
    raw = load_single_file(checkpoint, unet_config=ucfg, dtype=dtype)
    if validate:
        validate_against_shapes(raw["unet"], unet_param_shapes(ucfg))
    # SD1.x stores the encoder under te1 (HF naming); SD2.x under te2 (OpenCLIP)
    te = raw["text_encoder"] if family == "sd1" else raw["text_encoder_2"]
    params = {
        "unet": {k: jnp.asarray(v, cc.jnp_dtype) for k, v in raw["unet"].items()},
        "text_encoder": {k: jnp.asarray(v, jnp.float32) for k, v in te.items()},
        "vae": {k: jnp.asarray(v, jnp.float32) for k, v in raw["vae"].items()},
    }
    pipe = SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c1, vae_config=vcfg,
        params=params, compile_config=cc,
        clip_skip=2 if family == "sd2" else 1,
    )
    return pipe, family
