"""Device-mesh / sharding module.

The reference is strictly single-process single-GPU (SURVEY.md §2.7 — no
distributed code at all); its latency tech is CUDA graphs. This engine is
designed multi-device from day one: an explicit ``jax.sharding.Mesh`` with a
("data", "model") axis pair, where

  * "data"  shards the CFG/multi-prompt batch across devices (batched
    serving — the reference's planned multi-prompt config, BASELINE.json
    config #5);
  * "model" shards attention heads / MLP width tensor-parallel.

On one device both axes are size 1 and everything below is a no-op; scaling
out is a mesh-shape change, not a rewrite. XLA inserts the collectives (NCCL
on GPUs, which NVLink joins all to all, so the mesh shape follows the
algorithm alone).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """Mesh over all (or given) devices: data-parallel x tensor-parallel."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if data is None:
        data = n // model
    assert data * model == n, (data, model, n)
    return Mesh(devices.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding for activations."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_sharding(name: str, shape: tuple[int, ...], mesh: Mesh) -> NamedSharding:
    """Tensor-parallel layout for a UNet/CLIP/VAE param by state-dict name.

    Column-parallel (shard output features) for qkv/up projections, and
    row-parallel (shard input features) for the matching down projections, so
    the pair needs a single psum on the row-parallel output — the standard
    Megatron-style split, expressed purely as shardings for XLA to solve.
    Everything else (convs, norms, embeddings) is replicated: conv FLOPs are
    batch-sharded over "data" instead.
    """
    model = mesh.shape[MODEL_AXIS]
    if model == 1 or len(shape) != 2:
        return replicated(mesh)

    # Megatron discipline: column-parallel layers take REPLICATED input and
    # produce sharded output that ONLY an aligned consumer may read — here
    # the attention q/k/v projections, whose head-aligned column shards feed
    # attention with the exact same spec (no resharding at all), then
    # row-parallel to_out psums back to replicated. ff.net.2
    # is row-parallel over its input dim (replicated GEGLU output slices
    # locally for free, one psum on the way out).
    #
    # Deliberately NOT sharded (each was measured/derived to insert channel
    # all-gathers inside the scan, runtime/mesh HLO audit):
    #   .proj_in./.proj_out. — transformer block-boundary 1x1s; their
    #     consumers (LN + q/k/v) need full channels, so sharding them only
    #     buys a gather;
    #   .ff.net.0.proj. — the GEGLU up-projection's [state|gate] column
    #     concat is not shard-aligned (a contiguous "model" split puts state
    #     on one shard and gate on another); sharding it head-on forces a
    #     gather before the geglu. TP-sharding it needs a column interleave
    #     permutation at shard time + a shard-aware geglu (future work);
    #   .to_qkv./.to_kv. — same misalignment, which is why tensor-parallel
    #     pipelines keep the projections unfused (pipeline.__post_init__).
    # Scoped to UNet transformer blocks: the VAE's single-head mid attention
    # reuses the .to_q/.to_out names but h=1 cannot head-shard, so sharding
    # its projections only buys per-call channel gathers.
    col = (".to_q.", ".to_k.", ".to_v.")
    row = (".to_out.0.", ".ff.net.2.")
    if "transformer_blocks" not in name:
        return replicated(mesh)
    if name.endswith(".weight"):
        if any(m in name for m in col) and shape[1] % model == 0:
            return NamedSharding(mesh, P(None, MODEL_AXIS))
        if any(m in name for m in row) and shape[0] % model == 0:
            return NamedSharding(mesh, P(MODEL_AXIS, None))
    return replicated(mesh)


def audit_hlo_collectives(hlo_text: str, *, max_gather_bytes: int = 4096):
    """Return the all-gather lines in a compiled (post-SPMD) HLO dump that
    materialize more than ``max_gather_bytes`` per device.

    The partitioning tripwire for this module's whole design: a mis-specced
    mesh, or an op XLA cannot partition, silently all-gathers (B, S, H*D)
    activations in the scan body instead of running collective-free.
    Activation gathers are
    KBs-to-MBs; the legitimate residue (token-id/seed bookkeeping) is bytes —
    the default threshold separates them at any model scale. Row-parallel
    psums are all-reduce, not all-gather, and pass untouched."""
    import re

    itemsize = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
                "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8}
    bad = []
    for line in hlo_text.splitlines():
        m = re.search(r"= (\w+)\[([\d,]*)\]\S* all-gather", line)
        if m is None:
            continue
        dt, dims = m.groups()
        nbytes = itemsize.get(dt, 4)
        for d in dims.split(","):
            if d:
                nbytes *= int(d)
        if nbytes > max_gather_bytes:
            bad.append(line.strip())
    return bad


def shard_params(params: dict, mesh: Mesh) -> dict:
    """Device-put a flat param dict with tensor-parallel shardings.

    Quantized (w_int8, scale) pairs (compile.quantize_linear_weights) shard
    the int8 weight by the usual name rules; the per-out-channel scale
    follows the weight's output-dim sharding."""
    out = {}
    for k, v in params.items():
        if isinstance(v, tuple):
            wq, scale = v
            ws = param_sharding(k, wq.shape, mesh)
            sspec = P(ws.spec[1]) if len(ws.spec) == 2 else P()
            out[k] = (
                jax.device_put(wq, ws),
                jax.device_put(scale, NamedSharding(mesh, sspec)),
            )
        else:
            out[k] = jax.device_put(v, param_sharding(k, v.shape, mesh))
    return out
