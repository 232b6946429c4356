"""Full-UNet cross-validation against an independent torch implementation.

The strongest offline evidence that this framework's SDXL UNet semantics and
HF-state_dict layout are right: ingest the weights of the *reference repo's*
own torch SDXL UNet (reference ``src/stabletriton/optimizers/unet_pt.py`` —
a hand-written, torch-only, full 2.57B-param SDXL-base topology with exact HF
module naming) via ``io.torch_ingest.state_dict_to_params`` and assert forward
parity at reduced latent size. The oracle is non-repo code: any divergence in
key naming, weight layout/transposes, time-embedding conventions, attention
math, or block wiring fails this test.

Runs on CPU (fp32, both sides); reduced 16x16 latents keep it to ~2-4 min.
"""

import pathlib

import numpy as np
import pytest

REF = pathlib.Path("/root/reference/src")

pytestmark = pytest.mark.skipif(
    not (REF / "stabletriton/optimizers/unet_pt.py").exists(),
    reason="reference repo not available as oracle",
)


def test_sdxl_unet_matches_reference_torch_oracle():
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    # load the module file directly: the reference package __init__ imports
    # CUDA-only deps (xformers) that don't exist here, but unet_pt.py itself
    # is torch-only
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_unet_pt", REF / "stabletriton/optimizers/unet_pt.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    UNet2DConditionModel = mod.UNet2DConditionModel

    from stabletriton_jax.io.torch_ingest import state_dict_to_params
    from stabletriton_jax.models.unet import sdxl_base_unet_config, unet_apply

    torch.manual_seed(0)
    with torch.no_grad():
        oracle = UNet2DConditionModel().eval()
        # random-init weights are badly scaled for a 10-layer residual stack
        # (activations blow up past fp32 range); damp them into a regime where
        # both implementations produce O(1) activations. This perturbs every
        # tensor independently, so layout/naming bugs still break parity.
        for p in oracle.parameters():
            p.mul_(0.2)

    params = {
        k: jnp.asarray(v)
        for k, v in state_dict_to_params(oracle, dtype=np.float32).items()
    }
    cfg = sdxl_base_unet_config()

    # ingestion must cover the model's exact shape table (both directions)
    from stabletriton_jax.io.safetensors_io import validate_against_shapes
    from stabletriton_jax.models.unet import unet_param_shapes

    validate_against_shapes(
        {k: np.asarray(v) for k, v in params.items()}, unet_param_shapes(cfg)
    )

    rng = np.random.default_rng(0)
    b, lat = 1, 16
    sample = rng.standard_normal((b, 4, lat, lat)).astype(np.float32)
    t = np.full((b,), 500.0, np.float32)
    ctx = rng.standard_normal((b, 77, 2048)).astype(np.float32) * 0.1
    text_embeds = rng.standard_normal((b, 1280)).astype(np.float32) * 0.1
    time_ids = np.tile([128, 128, 0, 0, 128, 128], (b, 1)).astype(np.float32)

    with torch.no_grad():
        want = oracle(
            torch.from_numpy(sample),
            torch.from_numpy(t),
            torch.from_numpy(ctx),
            {"text_embeds": torch.from_numpy(text_embeds),
             "time_ids": torch.from_numpy(time_ids)},
        )[0].numpy()

    got = unet_apply(
        cfg, params,
        jnp.asarray(sample.transpose(0, 2, 3, 1)),  # NCHW -> NHWC
        jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(text_embeds),
        jnp.asarray(time_ids),
    )
    got = np.asarray(got).transpose(0, 3, 1, 2)

    assert got.shape == want.shape
    denom = max(1e-6, float(np.abs(want).max()))
    rel = float(np.abs(got - want).max()) / denom
    assert rel < 1e-3, f"max relative deviation {rel:.2e} vs torch oracle"
