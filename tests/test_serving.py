"""Serving engine tests: dynamic batching, determinism, mixed signatures."""

import numpy as np
import pytest

from stabletriton_jax.runtime.pipeline import make_tiny_pipeline
from stabletriton_jax.runtime.serving import Request, ServingEngine, _bucket


class IdentityTok:
    """Maps prompts to deterministic token ids without vocab files."""

    def encode_batch(self, texts, *, max_len=16, pad=0, **kw):
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [1] + [(ord(c) % 90) + 5 for c in t[: max_len - 2]] + [99]
            out[i, : len(ids)] = ids
        return out


def test_bucket_sizes():
    assert [_bucket(n) for n in (1, 2, 3, 4, 5, 8, 20)] == [1, 2, 4, 4, 8, 8, 8]


@pytest.fixture(scope="module")
def engine():
    pipe = make_tiny_pipeline()
    eng = ServingEngine(pipe, IdentityTok(), IdentityTok(), max_wait_s=0.2)
    yield eng
    eng.close()


def test_single_request(engine):
    img = engine.generate("a cat", height=32, width=32, steps=2, seed=7)
    assert img.shape == (32, 32, 3)


def test_batching_and_per_request_determinism(engine):
    kw = dict(height=32, width=32, steps=2)
    # solo run
    solo = engine.generate("a dog", seed=11, **kw)
    # batched with three other prompts (forces bucket 4)
    futs = [
        engine.submit(Request(prompt=p, seed=s, **kw))
        for p, s in [("a dog", 11), ("x", 1), ("y", 2), ("z", 3)]
    ]
    batched = futs[0].result()
    for f in futs[1:]:
        f.result()
    np.testing.assert_allclose(solo, batched, atol=2e-5)


def test_mixed_signatures_split_groups(engine):
    kw = dict(height=32, width=32)
    futs = [
        engine.submit(Request(prompt="a", steps=2, **kw)),
        engine.submit(Request(prompt="b", steps=3, **kw)),  # different signature
        engine.submit(Request(prompt="c", steps=2, **kw)),
    ]
    outs = [f.result(timeout=600) for f in futs]
    assert all(o.shape == (32, 32, 3) for o in outs)


def test_draft_knobs_split_signatures_and_serve(engine):
    """deep_cache / guidance_interval are part of the batching signature:
    requests with different knobs must not share a program, and both knob
    paths serve valid images through the engine."""
    kw = dict(height=32, width=32, steps=3)
    exact = Request(prompt="a", **kw)
    dc = Request(prompt="a", deep_cache=2, **kw)
    gi = Request(prompt="a", guidance_interval=(0.3, 5.0), **kw)
    assert len({exact.signature, dc.signature, gi.signature}) == 3
    futs = [engine.submit(r) for r in (exact, dc, gi)]
    outs = [f.result(timeout=600) for f in futs]
    assert all(o.shape == (32, 32, 3) for o in outs)
    assert all(np.isfinite(o).all() for o in outs)
    assert not np.array_equal(outs[0], outs[1])


def test_error_propagates():
    pipe = make_tiny_pipeline()
    eng = ServingEngine(pipe, IdentityTok(), IdentityTok(), max_wait_s=0.01)
    try:
        fut = eng.submit(Request(prompt="p", height=31, width=32, steps=1))
        with pytest.raises(Exception):
            fut.result(timeout=300)
    finally:
        eng.close()


def test_meshed_engine_rejects_incompatible_max_batch():
    """A caller's max_batch cap must never be silently exceeded: below the
    smallest mesh-compatible bucket it is an explicit error."""
    import jax
    import pytest

    from stabletriton_jax.runtime import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(data=4, model=2, devices=jax.devices()[:8])
    pipe = make_tiny_pipeline(mesh=mesh)
    with pytest.raises(ValueError, match="max_batch"):
        ServingEngine(pipe, IdentityTok(), IdentityTok(), max_batch=2)


def test_meshed_engine_buckets_and_serves():
    """A sharded pipeline serves through the engine: bucket sizes snap to
    multiples of the data axis so batches shard evenly across ICI."""
    import jax

    from stabletriton_jax.runtime import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(data=4, model=2, devices=jax.devices()[:8])
    pipe = make_tiny_pipeline(mesh=mesh)
    eng = ServingEngine(pipe, IdentityTok(), IdentityTok(), max_wait_s=0.05)
    try:
        assert eng._buckets == (4, 8, 16, 32)
        img = eng.generate("a cat", height=32, width=32, steps=2, seed=7)
        assert img.shape == (32, 32, 3)
        assert np.isfinite(img).all()
        # determinism vs the unsharded pipeline through the same engine path
        solo_pipe = make_tiny_pipeline()
        solo_eng = ServingEngine(solo_pipe, IdentityTok(), IdentityTok(),
                                 max_wait_s=0.05)
        try:
            solo = solo_eng.generate("a cat", height=32, width=32, steps=2, seed=7)
            np.testing.assert_allclose(solo, img, atol=2e-4)
        finally:
            solo_eng.close()
    finally:
        eng.close()
