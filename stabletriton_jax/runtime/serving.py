"""Batched multi-prompt / multi-resolution serving (BASELINE config #5).

The reference was a single-prompt script; its planned serving story was
"batched multi-prompt" (never built). Design: a dynamic batcher in
front of the signature-cached pipeline —

  * requests queue up; a worker groups them by compile signature
    (resolution, steps, guidance, solver) so one jitted program serves the
    whole group;
  * group batch is padded up to a bucket size (1/2/4/8) so the XLA program
    cache stays small and every launch hits a warm executable;
  * per-request seeds ride along, so batching never changes a request's image
    (same seed -> same image at any batch position).

Pure host-side threading; device work stays one jitted call per group.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future

import numpy as np

_BUCKETS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class Request:
    prompt: str
    negative: str = ""
    height: int = 1024
    width: int = 1024
    steps: int = 30
    guidance_scale: float = 5.0
    solver: str = "euler"
    seed: int = 0
    # draft-mode knobs (see SDXLPipeline.txt2img) — part of the batching
    # signature: requests only share a program if they sample identically
    guidance_interval: tuple[float, float] | None = None
    deep_cache: int | tuple[int, int] | None = None

    @property
    def signature(self):
        # normalize deep_cache like SDXLPipeline._norm_deep_cache so
        # deep_cache=2 and deep_cache=(2, 1) requests co-batch (they share
        # one compiled program)
        dc = self.deep_cache
        if isinstance(dc, (tuple, list)):
            dc = (int(dc[0]), int(dc[1]))
        elif dc is not None:
            dc = (int(dc), 1)
        # normalize guidance_interval the same way (SDXLPipeline._norm_gi):
        # a JSON-deserialized list would otherwise make the signature
        # unhashable, int-vs-float bounds would split co-batchable requests,
        # and an inert interval (g <= 1) would split them from plain no-CFG
        g = float(self.guidance_scale)
        gi = self.guidance_interval
        gi = (None if gi is None or g <= 1.0
              else (float(gi[0]), float(gi[1])))
        return (self.height, self.width, self.steps, g, self.solver, gi, dc)


def _bucket(n: int, buckets=_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ServingEngine:
    """Dynamic-batching frontend over an SDXLPipeline."""

    def __init__(self, pipeline, tok1, tok2, *, max_batch: int = _BUCKETS[-1],
                 max_wait_s: float = 0.05):
        self.pipeline = pipeline
        self.tok1, self.tok2 = tok1, tok2
        # mesh-aware buckets: a sharded pipeline needs batches divisible by
        # the data axis (requests shard across ICI, BASELINE config #5)
        data = 1
        if getattr(pipeline, "mesh", None) is not None:
            from stabletriton_jax.runtime import mesh as mesh_mod

            data = pipeline.mesh.shape[mesh_mod.DATA_AXIS]
        self._buckets = tuple(b * data for b in _BUCKETS)
        if max_batch < self._buckets[0]:
            # never silently exceed a caller's memory/latency cap: a sharded
            # pipeline cannot run batches below the data-axis multiple
            raise ValueError(
                f"max_batch={max_batch} is below the smallest mesh-compatible "
                f"bucket {self._buckets[0]} (data axis {data}); raise "
                f"max_batch or use a smaller data axis"
            )
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue[tuple[Request, Future] | None]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, request: Request) -> Future:
        fut: Future = Future()
        self._q.put((request, fut))
        return fut

    def generate(self, prompt: str, **kw) -> np.ndarray:
        return self.submit(Request(prompt=prompt, **kw)).result()

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=30)

    # -- worker -------------------------------------------------------------
    def _drain_group(self, first):
        """Collect up to max_batch same-signature requests within the window."""
        group = [first]
        deadline = self.max_wait_s
        leftovers = []
        try:
            while len(group) < self.max_batch:
                item = self._q.get(timeout=deadline)
                if item is None:
                    leftovers.append(None)
                    break
                if item[0].signature == first[0].signature:
                    group.append(item)
                else:
                    leftovers.append(item)
        except queue.Empty:
            pass
        for item in leftovers:
            self._q.put(item)
        return group

    def _worker(self):
        import jax.numpy as jnp

        while True:
            item = self._q.get()
            if item is None:
                return
            group = self._drain_group(item)
            reqs = [r for r, _ in group]
            futs = [f for _, f in group]
            try:
                n = len(reqs)
                bucket = _bucket(n, self._buckets)
                pad = bucket - n
                prompts = [r.prompt for r in reqs] + [""] * pad
                negatives = [r.negative for r in reqs] + [""] * pad
                seq1 = self.pipeline.clip_config.max_position_embeddings
                ids1 = self.tok1.encode_batch(prompts, max_len=seq1)
                neg1 = self.tok1.encode_batch(negatives, max_len=seq1)
                seq2 = self.pipeline.clip2_config.max_position_embeddings
                ids2 = self.tok2.encode_batch(prompts, max_len=seq2, pad=0)
                neg2 = self.tok2.encode_batch(negatives, max_len=seq2, pad=0)
                r0 = reqs[0]
                # per-request seeds ride as a tensor input: one shared program
                # per bucket, deterministic per request at any batch position
                seed = np.asarray([r.seed for r in reqs] + [0] * pad, np.uint32)
                imgs = self.pipeline.txt2img(
                    jnp.asarray(ids1), jnp.asarray(ids2),
                    neg_ids1=jnp.asarray(neg1), neg_ids2=jnp.asarray(neg2),
                    height=r0.height, width=r0.width, steps=r0.steps,
                    guidance_scale=r0.guidance_scale, solver=r0.solver,
                    seed=seed, guidance_interval=r0.guidance_interval,
                    deep_cache=r0.deep_cache,
                )
                imgs = np.asarray(imgs)
                for i, fut in enumerate(futs):
                    fut.set_result(imgs[i])
            except Exception as e:  # deliver failures to every waiter
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
