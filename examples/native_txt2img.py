"""Native whole-loop txt2img — the maximum-throughput path.

Loads an SDXL checkpoint directory torch-free, compiles the single-program
pipeline (CLIP -> scan denoise -> VAE), and writes PNGs via the native
encoder. This is the path the reference could not offer: its envelope ended
at the UNet, with encoders/scheduler/VAE in eager torch (SURVEY.md §3.4).

Usage:
    python examples/native_txt2img.py /path/to/sdxl-base-checkpoint \
        "a prompt" [more prompts ...]
"""

import sys
import time


def main():
    if len(sys.argv) < 3:
        print(__doc__)
        return 1
    root, prompts = sys.argv[1], sys.argv[2:]

    from stabletriton_jax import CompileConfig
    from stabletriton_jax.io.pretrained import load_sdxl
    from stabletriton_jax.io.tokenizer import sdxl_tokenize
    from stabletriton_jax.native import save_png

    import jax.numpy as jnp
    import numpy as np

    pipe, tok1, tok2 = load_sdxl(
        root, compile_config=CompileConfig(dtype="bfloat16")
    )
    ids1, ids2 = sdxl_tokenize(tok1, tok2, prompts)

    t0 = time.perf_counter()
    imgs = pipe.txt2img(jnp.asarray(ids1), jnp.asarray(ids2), steps=30, seed=0)
    imgs = np.asarray(imgs)
    print(f"first call (compile + run): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    imgs = np.asarray(
        pipe.txt2img(jnp.asarray(ids1), jnp.asarray(ids2), steps=30, seed=1)
    )
    dt = time.perf_counter() - t0
    print(f"steady state: {dt:.2f}s for {len(prompts)} image(s) "
          f"({30 * len(prompts) / dt:.2f} UNet it/s)")

    for i, img in enumerate(imgs):
        save_png(img, f"out_{i}.png")
        print(f"wrote out_{i}.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
