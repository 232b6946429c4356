"""Self-contained exercise of the fidelity gate machinery (CPU, tiny model):
record a trajectory with the reference binding, gate the platform binding
against it — proving the harness catches/passes numerics end to end."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from stabletriton_jax.compile import CompileConfig, compile_unet
from stabletriton_jax.runtime import scheduler as sched
from stabletriton_jax.runtime.pipeline import make_tiny_pipeline


def _load_fidelity():
    path = pathlib.Path(__file__).parent.parent / "benchmarks" / "fidelity.py"
    spec = importlib.util.spec_from_file_location("fidelity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_reference(pipe, steps=3, size=32, guidance=5.0, seed=0):
    """Produce the same dict dump_reference_latents.py would, using the
    reference binding as the oracle."""
    rng = np.random.default_rng(seed)
    d_ctx = pipe.unet_config.cross_attention_dim
    pe = rng.standard_normal((1, 7, d_ctx)).astype(np.float32)
    npe = rng.standard_normal((1, 7, d_ctx)).astype(np.float32)
    pooled = rng.standard_normal((1, 16)).astype(np.float32)
    npooled = rng.standard_normal((1, 16)).astype(np.float32)
    init = rng.standard_normal((1, 4, size // 8, size // 8)).astype(np.float32)

    schedule = sched.make_schedule(pipe.scheduler_config, steps)
    fn = compile_unet(pipe.unet_config, CompileConfig(backend="reference", dtype="float32"))
    ctx = jnp.asarray(np.concatenate([npe, pe]))
    po = jnp.asarray(np.concatenate([npooled, pooled]))
    tid = np.array([size, size, 0, 0, size, size], np.float32)
    time_ids = jnp.asarray(np.tile(tid, (2, 1)))

    lat = jnp.asarray(init.transpose(0, 2, 3, 1)) * schedule.init_noise_sigma
    traj = []
    for i in range(steps):
        sigma, sigma_next = schedule.sigmas[i], schedule.sigmas[i + 1]
        t = jnp.full((2,), float(schedule.timesteps[i]))
        inp = sched.scale_model_input(lat, sigma)
        eps = fn(pipe.params["unet"], jnp.concatenate([inp, inp]), t, ctx, po, time_ids)
        eps_u, eps_c = jnp.split(eps, 2)
        lat = sched.euler_step(lat, eps_u + guidance * (eps_c - eps_u), sigma, sigma_next)
        traj.append(np.asarray(lat).transpose(0, 3, 1, 2))

    return {
        "init_latents": init, "prompt_embeds": pe, "negative_prompt_embeds": npe,
        "pooled": pooled, "negative_pooled": npooled,
        "latents_per_step": np.stack(traj), "steps": steps,
        "guidance": guidance, "size": size,
    }


def test_gate_passes_for_platform_binding():
    pipe = make_tiny_pipeline(CompileConfig(dtype="float32"))
    ref = _record_reference(pipe)
    fidelity = _load_fidelity()
    assert fidelity.run_gate(pipe, ref, backend_label="platform", tol=1e-3)


def test_gate_fails_for_wrong_weights():
    pipe = make_tiny_pipeline(CompileConfig(backend="reference", dtype="float32"))
    ref = _record_reference(pipe)
    # corrupt one weight: the gate must notice
    key = "mid_block.resnets.0.conv1.weight"
    pipe.params["unet"][key] = pipe.params["unet"][key] * 1.5
    fidelity = _load_fidelity()
    assert not fidelity.run_gate(pipe, ref, backend_label="corrupted", tol=1e-3)
