"""LoRA weight patching (BASELINE.json config #5: "LoRA-patched UNet weights").

The reference had no LoRA support (load-only checkpointing, SURVEY.md §5);
this closes that gap jit-style: LoRA deltas are *folded into the base params*
before jit, so the hot path is unchanged — no per-step adapter matmuls, and
re-patching with a different scale is a host-side pytree update followed by a
cheap re-dispatch (same executable, new param buffers).

Supported tensor-name dialects:
  * diffusers/PEFT:  ``{module}.lora_A.weight`` / ``{module}.lora_B.weight``
  * kohya/A1111:     ``lora_unet_{module_with_underscores}.lora_down.weight``
                     / ``.lora_up.weight`` / ``.alpha``
"""

from __future__ import annotations

import numpy as np


def _module_key_index(params: dict) -> dict[str, str]:
    """underscored module path -> real param key prefix (kohya demangling)."""
    idx = {}
    for k in params:
        if k.endswith(".weight"):
            mod = k[: -len(".weight")]
            idx[mod.replace(".", "_")] = mod
    return idx


def extract_lora_pairs(lora_sd: dict[str, np.ndarray], params: dict) -> list[dict]:
    """Normalize a raw LoRA state_dict into [{target, down, up, alpha}]."""
    pairs: dict[str, dict] = {}

    def slot(target):
        return pairs.setdefault(target, {"target": target, "alpha": None})

    underscore_idx = _module_key_index(params)
    for name, arr in lora_sd.items():
        arr = np.asarray(arr)
        if ".lora_A." in name or ".lora_B." in name:  # diffusers/PEFT
            which = "down" if ".lora_A." in name else "up"
            target = name.split(".lora_A.")[0].split(".lora_B.")[0]
            for pre in ("unet.", "text_encoder.", "text_encoder_2."):
                if target.startswith(pre):
                    target = target[len(pre):]
            slot(target + ".weight")[which] = arr
        elif name.startswith("lora_unet_") or name.startswith("lora_te"):  # kohya
            base = name.split(".", 1)
            mangled = base[0]
            for pre in ("lora_unet_", "lora_te1_", "lora_te2_", "lora_te_"):
                if mangled.startswith(pre):
                    mangled = mangled[len(pre):]
            target_mod = underscore_idx.get(mangled)
            if target_mod is None:
                continue  # adapter for a module this model doesn't have
            tail = base[1] if len(base) > 1 else ""
            s = slot(target_mod + ".weight")
            if tail.startswith("lora_down"):
                s["down"] = arr
            elif tail.startswith("lora_up"):
                s["up"] = arr
            elif tail == "alpha":
                s["alpha"] = float(arr)
    return [p for p in pairs.values() if "down" in p and "up" in p]


def apply_lora(
    params: dict,
    lora_sd: dict[str, np.ndarray],
    *,
    scale: float = 1.0,
) -> dict:
    """Return a new param dict with LoRA deltas folded in.

    Base params are in framework layout (linear (in, out)); LoRA tensors are
    torch layout: down (r, in), up (out, r). delta^T = (up @ down)^T = in x out.
    """
    out = dict(params)
    n_applied = 0
    for pair in extract_lora_pairs(lora_sd, params):
        key = pair["target"]
        w = out.get(key)
        if w is None or np.ndim(w) != 2:
            continue
        down = pair["down"].astype(np.float32)
        up = pair["up"].astype(np.float32)
        r = down.shape[0]
        alpha = pair["alpha"] if pair["alpha"] is not None else float(r)
        delta = (up @ down).T * (scale * alpha / r)  # (in, out)
        if delta.shape != tuple(np.shape(w)):
            raise ValueError(f"{key}: LoRA delta {delta.shape} vs base {np.shape(w)}")
        out[key] = (np.asarray(w, np.float32) + delta).astype(np.asarray(w).dtype)
        n_applied += 1
    if n_applied == 0:
        raise ValueError("no LoRA tensors matched this model's parameters")
    return out
