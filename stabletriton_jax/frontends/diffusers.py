"""Diffusers drop-in frontend: ``compile(pipe.unet)`` -> replacement UNet.

The reference's working integration (reference
``implementations/Diffusers/load_sdxl_pipeline.py:16-35``): build a traceable
UNet, load the pipeline's weights, ``optimize_model`` it, splice it back with
``pipe.unet = unet_new``. The equivalent here gives torch users the same
one-call splice: ``pipe.unet = stabletriton_jax.frontends.diffusers.compile(pipe.unet)``
returns a callable that ingests the torch module's config+weights once, runs
every forward through the jitted, platform-bound UNet, and speaks the
diffusers calling convention (NCHW sample, ``encoder_hidden_states``,
``added_cond_kwargs={"text_embeds", "time_ids"}``, ``.config`` attribute,
``return_dict`` result shim).

For peak throughput use the native pipeline (runtime/pipeline.py) instead —
this wrapper pays one host<->device round trip per UNet call, exactly like the
reference paid one graph-replay dispatch per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from stabletriton_jax.compile import (
    CompileConfig,
    compile_unet,
    compile_unet_deepcache,
)
from stabletriton_jax.io.torch_ingest import state_dict_to_params, unet_config_from_diffusers


@dataclass
class _Output:
    """Duck-types diffusers' UNet2DConditionOutput."""

    sample: Any

    def __getitem__(self, i):
        return (self.sample,)[i]


class CompiledUNet:
    """Drop-in replacement for a diffusers SDXL UNet, executing through JAX."""

    def __init__(self, torch_unet, compile_config: CompileConfig | None = None,
                 deep_cache: int | None = None):
        np_params = state_dict_to_params(torch_unet, dtype=np.float32)
        self._setup(unet_config_from_diffusers(torch_unet.config), np_params,
                    compile_config, deep_cache, config=torch_unet.config)

    @classmethod
    def from_params(cls, unet_config, np_params,
                    compile_config: CompileConfig | None = None,
                    deep_cache: int | None = None):
        """Build the drop-in UNet from an already-converted framework param
        dict (HF keys, framework layout) instead of a live diffusers module —
        the entry the SGM/A1111 splice uses (frontends/sgm.py), where weights
        come from io.single_file / io.single_file.convert_sgm_unet rather
        than a torch UNet2DConditionModel."""
        self = cls.__new__(cls)
        self._setup(unet_config, np_params, compile_config, deep_cache,
                    config=None)
        return self

    def _setup(self, unet_config, np_params, compile_config, deep_cache,
               config):
        import jax.numpy as jnp

        self._jnp = jnp
        self.config = config  # diffusers pipeline reads this (None for SGM)
        self.unet_config = unet_config
        # per-step calls make a fresh device array from the torch sample every
        # time, so donating it is always safe here — the static-buffer analog
        # of the reference's CUDA-graph pools (SURVEY §2.4), relevant exactly
        # on this step-at-a-time path (the native pipeline jits the whole loop)
        self.compile_config = compile_config or CompileConfig(donate_sample=True)
        dtype = self.compile_config.jnp_dtype
        self.params = {k: jnp.asarray(v, dtype) for k, v in np_params.items()}
        self._fn = compile_unet(self.unet_config, self.compile_config)
        # DeepCache (Ma et al. 2023) for the step-at-a-time surface: the
        # frontend owns the step loop, so the deep-feature cache lives here
        # as host-side state instead of a scan carry. Draft semantics
        # (outside the exactness gate), like the native pipeline's knob.
        self.deep_cache = None if deep_cache is None else int(deep_cache)
        if self.deep_cache is not None and self.deep_cache < 1:
            raise ValueError(f"deep_cache interval must be >= 1: {deep_cache}")
        if self.deep_cache is not None:
            self._dc_full, self._dc_shallow = compile_unet_deepcache(
                self.unet_config, self.compile_config
            )
        # (step_idx, last_t, caches-per-call-slot, call_pos) — a scheduler
        # STEP can span several UNet calls (ComfyUI may run cond and uncond
        # as separate calls at the same timestep), so the step index advances
        # on timestep CHANGE and each call position within a step carries its
        # own cache slot (the call order per step is deterministic in every
        # frontend's loop)
        self._dc_state = None

    def reset_deep_cache(self):
        """Forget the carried cache. Called automatically when the timestep
        jumps back up (schedules are descending) or the sample shape changes;
        call it explicitly when aborting a generation mid-loop and starting
        another whose first timestep is not higher than the aborted one's
        last (e.g. aborted txt2img -> img2img)."""
        self._dc_state = None

    def _deep_cache_call(self, s, t, ehs, te, ti):
        """One UNet call under DeepCache host-side state (see __init__)."""
        t_now = float(np.asarray(t)[0])
        st = self._dc_state
        if st is not None and (t_now > st[1]
                               or st[2][0].shape[0] != s.shape[0]):
            st = None  # new generation (t jumped back up / batch changed)
        if st is None:
            step_idx, caches, call_pos = 0, [], 0
        else:
            step_idx, _, caches, call_pos = st
            if t_now != st[1]:
                step_idx, call_pos = step_idx + 1, 0
        full = step_idx % self.deep_cache == 0 or call_pos >= len(caches)
        if full:
            out, cache = self._dc_full(self.params, s, t, ehs, te, ti)
            if call_pos < len(caches):
                caches[call_pos] = cache
            else:
                caches.append(cache)
        else:
            out = self._dc_shallow(self.params, s, t, ehs, te, ti,
                                   caches[call_pos])
        self._dc_state = (step_idx, t_now, caches, call_pos + 1)
        return out

    @property
    def dtype(self):
        import torch

        return torch.float32

    @property
    def device(self):
        import torch

        return torch.device("cpu")

    def __call__(
        self,
        sample,
        timestep,
        encoder_hidden_states,
        *,
        added_cond_kwargs: dict | None = None,
        return_dict: bool = True,
        **_: Any,
    ):
        import torch

        jnp = self._jnp
        b = sample.shape[0]
        # NCHW torch -> NHWC jax
        s = jnp.asarray(
            sample.detach().to(torch.float32).cpu().numpy().transpose(0, 2, 3, 1)
        )
        if not hasattr(timestep, "shape") or getattr(timestep, "ndim", 0) == 0:
            t = jnp.full((b,), float(timestep), jnp.float32)
        else:
            t = jnp.asarray(
                timestep.detach().to(torch.float32).cpu().numpy()
            ).reshape(-1)
            if t.shape[0] == 1:
                t = jnp.broadcast_to(t, (b,))
        ehs = jnp.asarray(encoder_hidden_states.detach().to(torch.float32).cpu().numpy())
        acs = added_cond_kwargs or {}
        if "y" in acs and "text_embeds" not in acs:
            # SGM/ComfyUI convention: y = concat(pooled, fourier(time_ids)),
            # already projected to the add_embedding input width
            te = jnp.asarray(acs["y"].detach().to(torch.float32).cpu().numpy())
            ti = jnp.zeros((b, 0), jnp.float32)
        elif "text_embeds" in acs:
            te = jnp.asarray(acs["text_embeds"].detach().to(torch.float32).cpu().numpy())
            ti = jnp.asarray(acs["time_ids"].detach().to(torch.float32).cpu().numpy())
        else:
            # SD1.x/2.x: no added conditioning
            te = jnp.zeros((b, 0), jnp.float32)
            ti = jnp.zeros((b, 0), jnp.float32)

        if self.deep_cache is None:
            out = self._fn(self.params, s, t, ehs, te, ti)
        else:
            out = self._deep_cache_call(s, t, ehs, te, ti)
        out_t = torch.from_numpy(
            np.asarray(out.astype(jnp.float32)).transpose(0, 3, 1, 2).copy()
        ).to(sample.dtype)
        if return_dict:
            return _Output(sample=out_t)
        return (out_t,)


def compile(torch_unet, compile_config: CompileConfig | None = None,
            deep_cache: int | None = None) -> CompiledUNet:
    """The one-call API promised by the reference README (`model = compile(model)`).

    ``deep_cache=N`` (draft knob — DeepCache, Ma et al. 2023): full UNet
    every N-th step, only the outermost level (splicing the carried
    deep-feature cache) in between; generation boundaries are auto-detected
    from the descending timestep schedule (or call ``reset_deep_cache()``)."""
    return CompiledUNet(torch_unet, compile_config, deep_cache=deep_cache)
