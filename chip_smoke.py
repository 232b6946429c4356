"""Smoke test of the main path on one NVIDIA GPU at full SDXL-base width.

    python chip_smoke.py          # one card: the phases below
    python chip_smoke.py --four   # four cards: sharded txt2img vs one device

Phases (one process, one card):
  1. device      — JAX must report a GPU; prints the nvidia-smi card line.
  2. compile     — AOT-compiles the default-binding SDXL-base UNet step
                   (compile_unet_kv, 1024², CFG batch 2, bf16); prints
                   memory_analysis, what XLA made of the convs / attention,
                   and the compile time (set-up).
  3. kernels     — every op the GPU binding routes away from the plain
                   reference, at SDXL widths, against the float32 reference
                   at "highest" matmul precision on the same bf16-rounded
                   inputs; plus the plain conv2d (cuDNN through XLA).
  4. unet        — the default GPU binding (bf16) vs CompileConfig(
                   backend="reference", dtype="float32") at "highest", same
                   seeded random weights: MSE < 1e-3.
  5. pipeline    — SDXLPipeline.txt2img at 1024², 4 Euler steps with CFG,
                   then a ServingEngine answering 3 requests (two batch).
  6. card tests  — the tests marked ``gpu`` (tests/test_gpu.py).

Weights are random, drawn from a seed: no checkpoint is needed. A failed phase
makes the script exit non-zero; the last line, printed only when every phase
passed, is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

import jax
import jax.numpy as jnp

from stabletriton_jax import ops
from stabletriton_jax.compile import (
    CompileConfig,
    compile_unet,
    compile_unet_kv,
    enable_persistent_compile_cache,
    fuse_attention_projections,
    resolve_binding,
)
from stabletriton_jax.models import clip as clip_mod
from stabletriton_jax.models import vae as vae_mod
from stabletriton_jax.models.unet import init_unet_params, sdxl_base_unet_config
from stabletriton_jax.ops import reference
from stabletriton_jax.runtime import mesh as mesh_mod
from stabletriton_jax.runtime.pipeline import SDXLPipeline, _seed_vector
from stabletriton_jax.runtime.profiling import bench_fn
from stabletriton_jax.runtime.serving import Request, ServingEngine

MSE_GATE = 1e-3  # full-UNet deviation gate (fidelity gate of the repo)

# Phase-3 tolerance on rms(out - ref) / rms(ref), the relative L2 error.
# bf16 keeps 8 bits: one rounding is at most 2^-9 relative (rms ~1.1e-3),
# and a bf16 op rounds its inputs, its probabilities (attention) and its
# output. 1e-2 is about 2.5 bf16 ulps (2^-8 = 3.9e-3) of relative error: a
# correct kernel sits well below it, a wrong index or a lost scale far
# above. The fp32 VAE attention runs its products in TF32 on Hopper (10-bit
# mantissa), which the same bound covers.
REL_TOL = 1e-2

# (label, op, batch, heads, sq, sk, head_dim, dtype): self-attention is the
# fused-qkv op and cross-attention the fused-kv op, as the UNet calls them;
# the VAE mid-block runs the plain op in fp32.
ATTENTION_CASES = [
    ("self S=4096 h=10", "attention_qkv", 2, 10, 4096, 4096, 64, jnp.bfloat16),
    ("self S=1024 h=20", "attention_qkv", 2, 20, 1024, 1024, 64, jnp.bfloat16),
    ("cross 4096x77 h=10", "attention_kv", 2, 10, 4096, 77, 64, jnp.bfloat16),
    ("cross 1024x77 h=20", "attention_kv", 2, 20, 1024, 77, 64, jnp.bfloat16),
    ("vae S=16384 h=1 d=512", "attention", 1, 1, 16384, 16384, 512, jnp.float32),
]

# (label, batch, size, cin, cout, residual): SDXL resnet 3x3 convs, conv1
# form (per-batch time bias) and conv2 form (bias + residual skip)
CONV_CASES = [
    ("128² 320->320 +tbias", 2, 128, 320, 320, False),
    ("128² 320->320 +res", 2, 128, 320, 320, True),
    ("64² 320->640 +tbias", 2, 64, 320, 640, False),
    ("64² 640->640 +tbias", 2, 64, 640, 640, False),
    ("64² 640->640 +res", 2, 64, 640, 640, True),
    ("32² 640->1280 +tbias", 2, 32, 640, 1280, False),
    ("32² 1280->1280 +tbias", 2, 32, 1280, 1280, False),
    ("32² 1280->1280 +res", 2, 32, 1280, 1280, True),
]


class IdTokenizer:
    """Seeded tokenizer stand-in: maps text to ids with no vocab files."""

    def __init__(self, vocab: int, bos: int, eos: int):
        self.vocab, self.bos, self.eos = vocab, bos, eos

    def encode_batch(self, texts, *, max_len=77, pad=None, **kw):
        pad = self.eos if pad is None else pad
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            body = [(ord(c) * 31 + j) % (self.vocab - 3) + 1
                    for j, c in enumerate(t[: max_len - 2])]
            ids = [self.bos] + body + [self.eos]
            out[i, : len(ids)] = ids
        return out


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    """A phase's result is outside its stated limit."""


def require(ok, msg: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise PhaseFailed(msg)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, read
    by a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def check_device(count: int) -> dict:
    """Phase 1: the platform must be a GPU with at least ``count`` devices."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs an NVIDIA GPU; JAX found {devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"needs {count} GPUs; JAX found {len(devs)}")
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"[device] {info['kind']} x{len(devs)}")
    return info


# ---------------------------------------------------------------------------
# phase 2: compile only
# ---------------------------------------------------------------------------


def unet_inputs(cfg, lat: int, batch: int = 2, seed: int = 0):
    """Seeded (sample, t, ehs, text_embeds, time_ids) in float32."""
    rng = np.random.default_rng(seed)
    px = lat * 8
    return (
        jnp.asarray(rng.standard_normal((batch, lat, lat, cfg.in_channels), dtype=np.float32)),
        jnp.full((batch,), 500.0, jnp.float32),
        jnp.asarray(rng.standard_normal((batch, 77, cfg.cross_attention_dim), dtype=np.float32)),
        jnp.asarray(rng.standard_normal(
            (batch, cfg.projection_class_embeddings_input_dim
             - 6 * cfg.addition_time_embed_dim), dtype=np.float32)),
        jnp.asarray(np.tile([px, px, 0, 0, px, px], (batch, 1)).astype(np.float32)),
    )


def step_args(cfg, lat: int, dtype):
    """The scanned step's inputs as the pipeline passes them: latents and
    conditioning in the compute dtype, timesteps and time_ids in float32."""
    sample, t, ehs, te, tid = unet_inputs(cfg, lat)
    return sample.astype(dtype), t, ehs.astype(dtype), te.astype(dtype), tid


def hlo_counts(hlo: str) -> dict:
    """What XLA made of the step: cuDNN convs (and how many produce f32),
    cuDNN attention calls, transposes (and how many feed a conv)."""
    lines = hlo.splitlines()
    convs = [ln for ln in lines if 'custom_call_target="__cudnn$conv' in ln]
    transposes = [ln for ln in lines if " transpose(" in ln]
    return {
        "cudnn_conv": len(convs),
        "cudnn_conv_f32_out": sum("= (f32[" in ln for ln in convs),
        "cudnn_attention": sum('custom_call_target="__cudnn$fmha' in ln
                               for ln in lines),
        "transpose": len(transposes),
        "transpose_for_conv": sum("conv_general_dilated" in ln
                                  for ln in transposes),
    }


def phase_compile(cfg, lat: int, ccfg: CompileConfig):
    """AOT-compile the scanned UNet step; returns (compiled step, precompute)."""
    pre, _pre_t, step = compile_unet_kv(cfg, ccfg)
    dtype = ccfg.jnp_dtype
    params = jax.eval_shape(
        lambda: fuse_attention_projections(init_unet_params(cfg, 0, dtype=dtype)))
    sample, t, ehs, te, tid = jax.eval_shape(lambda: step_args(cfg, lat, dtype))
    kv = jax.eval_shape(pre, params, ehs)
    t0 = time.perf_counter()
    compiled = step.lower(params, sample, t, kv, te, tid).compile()
    secs = time.perf_counter() - t0
    log(f"[compile] UNet step {lat * 8}² CFG batch 2 {ccfg.dtype}: "
        f"{secs:.1f} s (set-up)")
    log(f"[compile] memory_analysis: {compiled.memory_analysis()}")
    log(f"[compile] HLO: {hlo_counts(compiled.as_text())}")
    return compiled, pre


# ---------------------------------------------------------------------------
# phase 3: kernel parity at real widths
# ---------------------------------------------------------------------------


def _compare(out, ref) -> tuple[float, float]:
    """(max abs error, rms error / rms of the reference output)."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    if out.shape != ref.shape or not np.isfinite(out).all():
        return float("inf"), float("inf")
    d = out - ref
    rms = lambda a: float(np.sqrt(np.mean(a * a)))  # noqa: E731
    return float(np.abs(d).max()), rms(d) / rms(ref)


def _reference_jit(fn):
    """fn jitted on float32 copies of its inputs at "highest" precision."""
    def f32(*a):
        with jax.default_matmul_precision("highest"):
            return fn(*(x.astype(jnp.float32) for x in a))
    return jax.jit(f32)


def attention_case(op, b, h, sq, sk, d, dtype, seed=0):
    """Inputs and the plain-reference function for one attention case."""
    rng = np.random.default_rng(seed)
    c = h * d

    def arr(*shape):
        return jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)

    if op == "attention_qkv":
        args = (arr(b, sq, 3 * c),)
        ref = lambda qkv: reference.attention_qkv(qkv, num_heads=h)  # noqa: E731
    elif op == "attention_kv":
        args = (arr(b, sq, c), arr(b, sk, 2 * c))
        ref = lambda q, kv: reference.attention_kv(q, kv, num_heads=h)  # noqa: E731
    else:
        args = (arr(b, sq, c), arr(b, sk, c), arr(b, sk, c))
        ref = lambda q, k, v: reference.attention(q, k, v, num_heads=h)  # noqa: E731
    return args, ref


def conv_case(b, size, cin, cout, residual, seed=0):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * scale
                           ).astype(jnp.bfloat16)

    x = arr(b, size, size, cin)
    w = arr(3, 3, cin, cout, scale=1.0 / np.sqrt(9 * cin))
    if residual:
        return (x, w, arr(cout), arr(b, size, size, cout))
    return (x, w, arr(b, cout))  # per-batch (B, Cout) bias: the time embedding


def _conv(x, w, bias, res=None):
    """conv2d through whatever backend the active binding selects."""
    return ops.conv2d(x, w, bias, residual=res)


def phase_kernels(attention_cases, conv_cases, *, binding, time_it=True):
    """Each case: op under ``binding`` vs the float32 "highest" reference on
    the same inputs. Returns rows; raises PhaseFailed past REL_TOL."""
    rows = []

    def run(label, fn, ref_fn, args, xla_fn=None):
        out = jax.block_until_ready(fn(*args))
        err, rel = _compare(out, ref_fn(*args))
        row = {"case": label, "dtype": str(args[0].dtype),
               "reference": "float32 highest", "max_abs": err,
               "rel_l2": rel, "tol": REL_TOL, "ok": rel <= REL_TOL}
        if time_it:
            row["ms"] = bench_fn(fn, *args) * 1e3
            if xla_fn is not None:
                row["xla_ms"] = bench_fn(xla_fn, *args) * 1e3
        rows.append(row)
        log(f"[kernels] {json.dumps(row)}")

    def bound(fn):
        """fn jitted with ``binding`` active while it traces."""
        def f(*a):
            with ops.use_backends(binding):
                return fn(*a)
        return jax.jit(f)

    for label, op, b, h, sq, sk, d, dtype in attention_cases:
        args, ref = attention_case(op, b, h, sq, sk, d, dtype)
        run(label, bound(functools.partial(ops.dispatch, op, num_heads=h)),
            _reference_jit(ref), args, xla_fn=jax.jit(ref))
    for label, b, size, cin, cout, residual in conv_cases:
        run(f"conv {label}", bound(_conv), _reference_jit(_conv),
            conv_case(b, size, cin, cout, residual))
    bad = [r["case"] for r in rows if not r["ok"]]
    require(not bad, f"over tolerance: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: UNet step parity
# ---------------------------------------------------------------------------


def phase_unet(cfg, lat: int, *, compiled=None, pre=None,
               ccfg: CompileConfig = CompileConfig()):
    """Default binding (ccfg) vs the float32 reference binding at "highest"
    on the same seeded weights and inputs. Returns (mse, bf16 params)."""
    inputs = unet_inputs(cfg, lat)
    params32 = init_unet_params(cfg, 0)
    ref_fn = compile_unet(cfg, CompileConfig(backend="reference", dtype="float32"))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(ref_fn(params32, *inputs), np.float32)
    params = fuse_attention_projections(
        jax.tree.map(lambda a: a.astype(ccfg.jnp_dtype), params32))
    del params32
    if compiled is None:
        pre, _pre_t, compiled = compile_unet_kv(cfg, ccfg)
    sample, t, ehs, te, tid = step_args(cfg, lat, ccfg.jnp_dtype)
    out = np.asarray(compiled(params, sample, t, pre(params, ehs), te, tid),
                     np.float32)
    mse = float(np.mean((out - ref) ** 2))
    log(f"[unet] {ccfg.dtype} default binding vs f32 reference (highest): "
        f"MSE {mse:.3e} (gate < {MSE_GATE:g}), max abs "
        f"{float(np.abs(out - ref).max()):.4f}, ref std {float(ref.std()):.4f}")
    require(np.isfinite(out).all(), "non-finite UNet output")
    require(mse < MSE_GATE, f"UNet MSE {mse:.3e} >= {MSE_GATE:g}")
    return mse, params


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


def make_pipeline(unet_cfg, clip1, clip2, vae_cfg, *, unet_params=None,
                  ccfg: CompileConfig = CompileConfig(), mesh=None, seed=0):
    """SDXLPipeline with seeded random weights (bf16 UNet, fp32 CLIP/VAE)."""
    if unet_params is None:
        unet_params = init_unet_params(unet_cfg, seed, dtype=ccfg.jnp_dtype)
    params = {
        "unet": unet_params,
        "text_encoder": clip_mod.init_clip_params(clip1, seed + 1),
        "text_encoder_2": clip_mod.init_clip_params(clip2, seed + 2),
        "vae": vae_mod.init_vae_params(vae_cfg, seed + 3),
    }
    return SDXLPipeline(unet_config=unet_cfg, clip_config=clip1,
                        clip2_config=clip2, vae_config=vae_cfg, params=params,
                        compile_config=ccfg, mesh=mesh)


def tokenizer_for(pipe) -> IdTokenizer:
    c = pipe.clip_config
    return IdTokenizer(c.vocab_size, c.bos_token_id, c.eos_token_id)


def _check_images(img, shape) -> None:
    img = np.asarray(img, np.float32)
    require(img.shape == shape, f"image shape {img.shape}, expected {shape}")
    require(np.isfinite(img).all(), "non-finite image")


def phase_txt2img(pipe, size: int, steps: int, card: str = ""):
    tok = tokenizer_for(pipe)
    mp = pipe.clip_config.max_position_embeddings
    ids = jnp.asarray(tok.encode_batch(["an astronaut riding a horse"], max_len=mp))
    times = []
    for seed in (0, 1):
        t0 = time.perf_counter()
        img = jax.block_until_ready(pipe.txt2img(ids, ids, height=size, width=size,
                                                 steps=steps, seed=seed))
        times.append(time.perf_counter() - t0)
        _check_images(img, (1, size, size, 3))
    log(f"[txt2img] {size}² b1 {steps} Euler steps CFG: image "
        f"{tuple(img.shape)} finite; first call {times[0]:.2f} s (compile + "
        f"run), second {times[1]:.2f} s  [{card}] (smoke reading, not a "
        f"benchmark)")
    return img


def phase_serving(pipe, size: int, steps: int, card: str = ""):
    """Three requests: two share a signature (no-CFG) and batch; the third
    is the txt2img signature."""
    tok = tokenizer_for(pipe)
    eng = ServingEngine(pipe, tok, tok, max_batch=2, max_wait_s=0.5)
    try:
        reqs = [
            Request("a red fox", height=size, width=size, steps=steps,
                    guidance_scale=1.0, seed=11),
            Request("a blue bird", height=size, width=size, steps=steps,
                    guidance_scale=1.0, seed=12),
            Request("a lighthouse", height=size, width=size, steps=steps,
                    guidance_scale=5.0, seed=13),
        ]
        t0 = time.perf_counter()
        futs = [eng.submit(r) for r in reqs]
        imgs = [f.result(timeout=1200) for f in futs]
        secs = time.perf_counter() - t0
    finally:
        eng.close()
    for img in imgs:
        _check_images(img, (size, size, 3))
    log(f"[serving] {len(imgs)} requests answered ({size}², {steps} steps; two "
        f"batched) in {secs:.2f} s  [{card}] (smoke reading); programs "
        f"compiled: {len(pipe.cache_signatures())}")
    return imgs


# ---------------------------------------------------------------------------
# card-only tests
# ---------------------------------------------------------------------------


def phase_card_tests() -> None:
    """Run the tests marked ``gpu`` in this process (it holds the card)."""
    import pytest

    os.environ["STABLETRITON_GPU_TESTS"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu.py")])
    require(rc == 0, f"card-only tests failed (pytest rc {rc})")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def four_card_configs():
    """SDXL-base widths with the depth cut (one transformer layer per level,
    two CLIP layers) so three whole-pipeline compiles fit one short call."""
    unet = dataclasses.replace(sdxl_base_unet_config(),
                               transformer_layers_per_block=(1, 1, 1))
    c1 = dataclasses.replace(clip_mod.sdxl_text_encoder_config(), num_layers=2)
    c2 = dataclasses.replace(clip_mod.sdxl_text_encoder_2_config(), num_layers=2)
    return unet, c1, c2, vae_mod.sdxl_vae_config()


def _run_program(pipe, ids, size, steps, batch):
    """AOT-compile and run one txt2img signature; returns (images, HLO)."""
    fn = pipe._txt2img_program(batch, size, size, steps, 5.0, "euler", False,
                               None, None)
    mp = pipe.clip_config.max_position_embeddings
    neg1 = jnp.asarray(pipe.clip_config.empty_prompt_ids(batch, mp))
    neg2 = jnp.asarray(pipe.clip2_config.empty_prompt_ids(batch, mp))
    args = pipe._shard_batch(ids, ids, neg1, neg2, _seed_vector(0, batch))
    compiled = fn.lower(pipe.params, *args).compile()
    img = np.asarray(jax.block_until_ready(compiled(pipe.params, *args)), np.float32)
    return img, compiled.as_text()


def phase_four(configs, devices, *, size: int, steps: int, batch: int = 4,
               meshes=((4, 1), (2, 2))):
    """txt2img on each (data, model) mesh vs the same seeds on one device.
    Returns rows; raises when a mesh differs past the gate or its program
    all-gathers activations."""
    unet_cfg, c1, c2, vae_cfg = configs
    unet_params = init_unet_params(unet_cfg, 0, dtype=jnp.bfloat16)
    single = make_pipeline(unet_cfg, c1, c2, vae_cfg, unet_params=unet_params)
    tok = tokenizer_for(single)
    prompts = [f"prompt number {i}" for i in range(batch)]
    ids = jnp.asarray(tok.encode_batch(prompts, max_len=c1.max_position_embeddings))
    want, _ = _run_program(single, ids, size, steps, batch)
    _check_images(want, (batch, size, size, 3))
    rows = []
    for data, model in meshes:
        mesh = mesh_mod.make_mesh(data=data, model=model, devices=devices)
        pipe = make_pipeline(unet_cfg, c1, c2, vae_cfg, unet_params=unet_params,
                             mesh=mesh)
        got, hlo = _run_program(pipe, ids, size, steps, batch)
        _check_images(got, (batch, size, size, 3))
        bad = mesh_mod.audit_hlo_collectives(hlo)
        d = got - want
        row = {"mesh": f"data={data} x model={model}",
               "mse_vs_one_device": float(np.mean(d * d)),
               "max_abs_vs_one_device": float(np.abs(d).max()),
               "activation_all_gathers": len(bad), "gate": MSE_GATE}
        rows.append(row)
        log(f"[four] {json.dumps(row)}")
        for line in bad[:5]:
            log(f"[four]   all-gather: {line[:200]}")
    for row in rows:
        require(row["activation_all_gathers"] == 0, f"all-gathers: {row}")
        require(row["mse_vs_one_device"] < MSE_GATE, f"over the gate: {row}")
    return rows


# ---------------------------------------------------------------------------


def _phase(name, failures, fn, *a, **kw):
    """Run one phase; a failure is reported, recorded and fails the run."""
    t0 = time.perf_counter()
    try:
        out = fn(*a, **kw)
    except Exception:  # recorded: the script exits non-zero at the end
        traceback.print_exc()
        failures.append(name)
        log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        return None
    log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded txt2img check")
    args = ap.parse_args(argv)

    count = 4 if args.four else 1
    device = check_device(count)
    card = card_line()
    log(f"[device] card: {card}")
    enable_persistent_compile_cache()
    failures: list[str] = []

    if args.four:
        _phase("four", failures, phase_four, four_card_configs(),
               jax.devices()[:4], size=512, steps=2)
    else:
        cfg = sdxl_base_unet_config()
        ccfg = CompileConfig()
        binding = resolve_binding(ccfg)
        log(f"[device] binding: {binding}")
        compiled = _phase("compile", failures, phase_compile, cfg, 128, ccfg)
        step, pre = compiled if compiled else (None, None)
        _phase("kernels", failures, phase_kernels, ATTENTION_CASES, CONV_CASES,
               binding=binding)
        res = _phase("unet", failures, phase_unet, cfg, 128, compiled=step,
                     pre=pre, ccfg=ccfg)
        unet_params = res[1] if res else None
        del step, pre, res
        pipe = make_pipeline(cfg, clip_mod.sdxl_text_encoder_config(),
                             clip_mod.sdxl_text_encoder_2_config(),
                             vae_mod.sdxl_vae_config(), unet_params=unet_params,
                             ccfg=ccfg)
        _phase("txt2img", failures, phase_txt2img, pipe, 1024, 4, card)
        _phase("serving", failures, phase_serving, pipe, 1024, 4, card)
        _phase("card-tests", failures, phase_card_tests)

    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
