"""Batched multi-prompt serving demo (BASELINE config #5).

Launches the dynamic-batching engine over a checkpoint and submits concurrent
requests at mixed resolutions; same-signature requests share one jitted
launch, per-request seeds keep every image reproducible.

Usage: python examples/serving_demo.py /path/to/sdxl-checkpoint
"""

import sys
import time


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        return 1
    root = sys.argv[1]

    from stabletriton_jax import CompileConfig
    from stabletriton_jax.io.pretrained import load_sdxl
    from stabletriton_jax.native import save_png
    from stabletriton_jax.runtime.serving import Request, ServingEngine

    pipe, tok1, tok2 = load_sdxl(
        root, compile_config=CompileConfig(dtype="bfloat16")
    )
    engine = ServingEngine(pipe, tok1, tok2, max_wait_s=0.2)

    prompts = [
        ("a watercolor fox in a snowy forest", 1024, 1024),
        ("a cyberpunk street at night, neon rain", 1024, 1024),
        ("a lighthouse on a cliff at dawn", 1024, 1024),
        ("macro photo of a dew-covered leaf", 768, 768),  # second signature
    ]
    t0 = time.perf_counter()
    futures = [
        engine.submit(Request(prompt=p, height=h, width=w, steps=30, seed=i))
        for i, (p, h, w) in enumerate(prompts)
    ]
    for i, fut in enumerate(futures):
        img = fut.result()
        save_png(img, f"serve_{i}.png")
        print(f"[{time.perf_counter() - t0:7.1f}s] wrote serve_{i}.png {img.shape}")
    engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
