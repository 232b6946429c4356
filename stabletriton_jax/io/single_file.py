"""Single-file SDXL checkpoint support (SGM / A1111 ``sd_xl_base_1.0.safetensors``).

The reference's Automatic1111/SGM integration never got past a stub + YAML
(reference ``implementations/sgm_/``); this module delivers the real thing
torch-free: the original-LDM ("SGM") tensor naming is remapped to the
Diffusers-style keys this framework's models use, for all four components in
the single file:

  model.diffusion_model.*        -> UNet        (resnet in_layers/out_layers ->
                                                 norm1/conv1/norm2/conv2, block
                                                 renumbering, etc.)
  first_stage_model.*            -> VAE decoder (mid.attn_1 1x1-convs -> linears)
  conditioner.embedders.0.*      -> CLIP-L      (already HF naming inside)
  conditioner.embedders.1.model.*-> CLIP-bigG   (OpenCLIP naming: fused
                                                 in_proj qkv split, ln_final ->
                                                 final_layer_norm, ...)

Layout conversion to (in,out)/HWIO happens after renaming via the same
``convert_state_dict`` the directory loader uses.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from stabletriton_jax.io.safetensors_io import convert_state_dict, read_safetensors
from stabletriton_jax.models.unet import UNetConfig

# ---------------------------------------------------------------------------
# UNet: SGM -> diffusers naming
# ---------------------------------------------------------------------------


def _unet_block_tables(cfg: UNetConfig):
    """input_blocks / output_blocks index -> diffusers module path."""
    in_map: dict[str, str] = {}
    n_levels = len(cfg.block_out_channels)
    idx = 1
    for level in range(n_levels):
        has_attn = cfg.down_block_types[level] == "CrossAttnDownBlock2D"
        for j in range(cfg.layers_per_block):
            in_map[f"input_blocks.{idx}.0"] = f"down_blocks.{level}.resnets.{j}"
            if has_attn:
                in_map[f"input_blocks.{idx}.1"] = f"down_blocks.{level}.attentions.{j}"
            idx += 1
        if level < n_levels - 1:
            in_map[f"input_blocks.{idx}.0.op"] = f"down_blocks.{level}.downsamplers.0.conv"
            idx += 1

    out_map: dict[str, str] = {}
    idx = 0
    for level in range(n_levels):
        utype = cfg.up_block_types[level]
        has_attn = utype == "CrossAttnUpBlock2D"
        for j in range(cfg.layers_per_block + 1):
            out_map[f"output_blocks.{idx}.0"] = f"up_blocks.{level}.resnets.{j}"
            if has_attn:
                out_map[f"output_blocks.{idx}.1"] = f"up_blocks.{level}.attentions.{j}"
            if j == cfg.layers_per_block and level < n_levels - 1:
                # upsampler rides in the last output block of the level, in
                # slot 1 (conv-only levels) or 2 (attention levels)
                slot = 2 if has_attn else 1
                out_map[f"output_blocks.{idx}.{slot}.conv"] = (
                    f"up_blocks.{level}.upsamplers.0.conv"
                )
            idx += 1
    return in_map, out_map


_RESNET_INNER = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}


def convert_sgm_unet(sd: dict[str, np.ndarray], cfg: UNetConfig | None = None):
    """{sgm unet name: tensor} (prefix stripped) -> diffusers-named dict."""
    cfg = cfg or UNetConfig()
    in_map, out_map = _unet_block_tables(cfg)
    fixed = {
        "time_embed.0": "time_embedding.linear_1",
        "time_embed.2": "time_embedding.linear_2",
        "label_emb.0.0": "add_embedding.linear_1",
        "label_emb.0.2": "add_embedding.linear_2",
        "input_blocks.0.0": "conv_in",
        "middle_block.0": "mid_block.resnets.0",
        "middle_block.1": "mid_block.attentions.0",
        "middle_block.2": "mid_block.resnets.1",
        "out.0": "conv_norm_out",
        "out.2": "conv_out",
    }

    def rename(name: str) -> str | None:
        for table in (out_map, in_map, fixed):  # longest/most specific first
            for pre, repl in table.items():
                if name.startswith(pre + "."):
                    rest = name[len(pre) + 1:]
                    base = repl
                    # resnet inner-module renames
                    for old, new in _RESNET_INNER.items():
                        if rest.startswith(old + "."):
                            rest = new + rest[len(old):]
                            break
                    return f"{base}.{rest}"
        return None

    out = {}
    for name, arr in sd.items():
        new = rename(name)
        if new is not None:
            out[new] = arr
    return out


# ---------------------------------------------------------------------------
# VAE decoder: SGM -> diffusers naming
# ---------------------------------------------------------------------------


def convert_sgm_vae_decoder(sd: dict[str, np.ndarray], n_up_levels: int = 4):
    """first_stage_model.* (prefix stripped) -> diffusers-named decoder dict.

    SGM's decoder numbers its up blocks from the *bottom* (up.3 runs first for
    a 4-level VAE); diffusers numbers them in execution order. The mid
    attention stores q/k/v/proj as 1x1 convs; diffusers uses linears.
    """
    out: dict[str, np.ndarray] = {}
    attn_ren = {"q": "to_q", "k": "to_k", "v": "to_v",
                "proj_out": "to_out.0", "norm": "group_norm"}
    for name, arr in sd.items():
        if name.startswith("post_quant_conv."):
            out[name] = arr
            continue
        if not name.startswith("decoder."):
            continue
        rest = name[len("decoder."):]
        parts = rest.split(".")
        if rest.startswith("conv_in.") or rest.startswith("conv_out."):
            out[f"decoder.{rest}"] = arr
        elif rest.startswith("norm_out."):
            out[f"decoder.conv_norm_out.{parts[-1]}"] = arr
        elif rest.startswith("mid.block_1."):
            out[_vae_resnet("decoder.mid_block.resnets.0", rest[len("mid.block_1."):])] = arr
        elif rest.startswith("mid.block_2."):
            out[_vae_resnet("decoder.mid_block.resnets.1", rest[len("mid.block_2."):])] = arr
        elif rest.startswith("mid.attn_1."):
            inner = rest[len("mid.attn_1."):]
            mod, leaf = inner.rsplit(".", 1)
            new = attn_ren.get(mod)
            if new is None:
                continue
            if new.startswith("to_") and arr.ndim == 4:
                arr = arr.reshape(arr.shape[0], arr.shape[1])  # 1x1 conv -> linear
            out[f"decoder.mid_block.attentions.0.{new}.{leaf}"] = arr
        elif parts[0] == "up":
            sgm_level = int(parts[1])
            level = n_up_levels - 1 - sgm_level  # reverse numbering
            if parts[2] == "block":
                j = int(parts[3])
                out[_vae_resnet(f"decoder.up_blocks.{level}.resnets.{j}",
                                ".".join(parts[4:]))] = arr
            elif parts[2] == "upsample":
                out[f"decoder.up_blocks.{level}.upsamplers.0.conv.{parts[-1]}"] = arr
    return out


def _vae_resnet(base: str, rest: str) -> str:
    ren = {"nin_shortcut": "conv_shortcut"}
    mod, leaf = rest.rsplit(".", 1)
    return f"{base}.{ren.get(mod, mod)}.{leaf}"


# ---------------------------------------------------------------------------
# OpenCLIP (bigG) -> HF CLIP naming
# ---------------------------------------------------------------------------


def convert_openclip_text(sd: dict[str, np.ndarray]):
    """conditioner.embedders.1.model.* (prefix stripped) -> HF CLIP names.

    OpenCLIP stores qkv fused (``attn.in_proj_weight`` (3d, d)); HF keeps them
    separate. ln_final -> final_layer_norm; text_projection stays (d, proj)
    which is already this framework's linear layout (flagged no-transpose).
    """
    out: dict[str, np.ndarray] = {}
    for name, arr in sd.items():
        if name == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = arr
        elif name == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = arr
        elif name.startswith("ln_final."):
            out[f"text_model.final_layer_norm.{name.split('.')[-1]}"] = arr
        elif name == "text_projection":
            # already (d, proj): mark so layout conversion must NOT transpose
            out["text_projection.weight@pretransposed"] = arr
        elif name.startswith("transformer.resblocks."):
            parts = name.split(".")
            i, rest = parts[2], ".".join(parts[3:])
            pre = f"text_model.encoder.layers.{i}"
            leaf = parts[-1]
            if rest.startswith("ln_1."):
                out[f"{pre}.layer_norm1.{leaf}"] = arr
            elif rest.startswith("ln_2."):
                out[f"{pre}.layer_norm2.{leaf}"] = arr
            elif rest.startswith("mlp.c_fc."):
                out[f"{pre}.mlp.fc1.{leaf}"] = arr
            elif rest.startswith("mlp.c_proj."):
                out[f"{pre}.mlp.fc2.{leaf}"] = arr
            elif rest.startswith("attn.in_proj_"):
                kind = "weight" if rest.endswith("weight") else "bias"
                q, k, v = np.split(arr, 3, axis=0)
                out[f"{pre}.self_attn.q_proj.{kind}"] = q
                out[f"{pre}.self_attn.k_proj.{kind}"] = k
                out[f"{pre}.self_attn.v_proj.{kind}"] = v
            elif rest.startswith("attn.out_proj."):
                out[f"{pre}.self_attn.out_proj.{leaf}"] = arr
    return out


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def detect_family(tensor_names) -> str:
    """"sdxl" | "sd2" | "sd1" from a single-file checkpoint's tensor names."""
    names = list(tensor_names)
    if any(n.startswith("conditioner.embedders.1.") for n in names):
        return "sdxl"
    if any(n.startswith("cond_stage_model.model.") for n in names):
        return "sd2"
    return "sd1"



def load_single_file(
    path: str | Path, *, unet_config: UNetConfig | None = None, dtype=None
):
    """Parse one SGM-format SDXL .safetensors into this framework's four param
    dicts: {"unet", "vae", "text_encoder", "text_encoder_2"} (framework layout).
    """
    raw = read_safetensors(path)
    groups: dict[str, dict[str, np.ndarray]] = {
        "unet_sgm": {}, "vae_sgm": {}, "te1": {}, "te2_openclip": {},
    }
    for name, arr in raw.items():
        if name.startswith("model.diffusion_model."):
            groups["unet_sgm"][name[len("model.diffusion_model."):]] = arr
        elif name.startswith("first_stage_model."):
            groups["vae_sgm"][name[len("first_stage_model."):]] = arr
        elif name.startswith("conditioner.embedders.0.transformer."):
            groups["te1"][name[len("conditioner.embedders.0.transformer."):]] = arr
        elif name.startswith("conditioner.embedders.1.model."):
            groups["te2_openclip"][name[len("conditioner.embedders.1.model."):]] = arr
        # SD1.x single files: HF-named CLIP-L under cond_stage_model.transformer
        elif name.startswith("cond_stage_model.transformer."):
            groups["te1"][name[len("cond_stage_model.transformer."):]] = arr
        # SD2.x single files: OpenCLIP-H under cond_stage_model.model
        elif name.startswith("cond_stage_model.model."):
            groups["te2_openclip"][name[len("cond_stage_model.model."):]] = arr

    unet = convert_sgm_unet(groups["unet_sgm"], unet_config)
    vae = convert_sgm_vae_decoder(groups["vae_sgm"])
    te1 = groups["te1"]
    te2 = convert_openclip_text(groups["te2_openclip"])

    def finish(d):
        converted = convert_state_dict(d, dtype=dtype)
        # honor the no-transpose marker
        fixed = {}
        for k, v in list(converted.items()):
            if k.endswith("@pretransposed"):
                base = k[: -len("@pretransposed")]
                fixed[base] = np.asarray(d[k], dtype or np.float32)
            else:
                fixed[k] = v
        return fixed

    return {
        "unet": finish(unet),
        "vae": finish(vae),
        "text_encoder": finish(te1),
        "text_encoder_2": finish(te2),
    }
