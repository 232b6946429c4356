"""Pure-Python safetensors reader + torch->JAX layout conversion.

The reference loads HF SDXL weights through torch
(``pipe.unet.state_dict()`` -> ``load_state_dict``, reference
``implementations/Diffusers/load_sdxl_pipeline.py:17-25``). A JAX host should
not need torch, so this module parses the safetensors container directly
(8-byte little-endian header length, JSON tensor table, raw data) with numpy
memory-mapping, and converts each tensor into this framework's layout:

  torch nn.Linear weight (out, in)  -> (in, out)      [x @ w needs no transpose]
  torch conv weight OIHW            -> HWIO
  embeddings / norms / biases       -> unchanged

Key names are preserved verbatim — the model pytrees use HF state_dict keys —
so ingestion is: parse, transpose by rank, done. LoRA patching builds on the
same reader (stabletriton_jax/io/lora.py).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,  # no numpy bf16; decoded via uint16 view below
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}

# SDXL checkpoints occasionally use pre-0.18 diffusers VAE attention naming.
_VAE_ATTN_RENAMES = {
    ".query.": ".to_q.",
    ".key.": ".to_k.",
    ".value.": ".to_v.",
    ".proj_attn.": ".to_out.0.",
}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Parse a .safetensors file -> {name: numpy array} (zero-copy views)."""
    path = Path(path)
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + header_len)

    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = data[start:end]
        dt = info["dtype"]
        if dt == "BF16":
            # widen bf16 -> fp32 (native/src/convert.cpp when built)
            from stabletriton_jax import native

            arr = native.bf16_to_f32(raw.view(np.uint16)).reshape(shape)
        else:
            np_dt = _DTYPES[dt]
            if np_dt is None:
                raise ValueError(f"unsupported dtype {dt} for {name}")
            arr = raw.view(np_dt).reshape(shape)
        out[name] = arr
    return out


def to_framework_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """Convert one torch-layout tensor to this framework's layout."""
    if not name.endswith(".weight"):
        return arr
    if "embedding" in name.rsplit(".", 2)[-2]:
        return arr  # token/position embeddings stay (vocab, d)
    from stabletriton_jax import native

    if arr.ndim == 2:
        return native.transpose_2d(arr)
    if arr.ndim == 4:
        return native.oihw_to_hwio(arr)  # OIHW -> HWIO
    return arr


def convert_state_dict(
    sd: dict[str, np.ndarray],
    *,
    strip_prefix: str = "",
    dtype=None,
) -> dict[str, np.ndarray]:
    """Whole state_dict -> framework param dict (renames + transposes + cast)."""
    out = {}
    for name, arr in sd.items():
        if strip_prefix and name.startswith(strip_prefix):
            name = name[len(strip_prefix):]
        for old, new in _VAE_ATTN_RENAMES.items():
            if old in name:
                name = name.replace(old, new)
        arr = to_framework_layout(name, np.asarray(arr))
        if dtype is not None:
            arr = arr.astype(dtype)
        out[name] = arr
    return out


def load_params(
    path: str | Path, *, strip_prefix: str = "", dtype=None
) -> dict[str, np.ndarray]:
    """read_safetensors + convert_state_dict in one call."""
    return convert_state_dict(
        read_safetensors(path), strip_prefix=strip_prefix, dtype=dtype
    )


def validate_against_shapes(
    params: dict[str, np.ndarray], expected: dict[str, tuple[int, ...]]
) -> None:
    """Assert a loaded param dict exactly matches a model's shape table."""
    missing = sorted(set(expected) - set(params))
    extra = sorted(set(params) - set(expected))
    if missing or extra:
        raise ValueError(
            f"param mismatch: {len(missing)} missing (e.g. {missing[:3]}), "
            f"{len(extra)} unexpected (e.g. {extra[:3]})"
        )
    for k, shape in expected.items():
        if tuple(params[k].shape) != tuple(shape):
            raise ValueError(f"{k}: shape {params[k].shape} != expected {shape}")
