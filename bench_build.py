"""Secondary benchmark: BASELINE config 4 — 10M x 768 -> 4096 centroids.

Measures the index-build path at the reference's headline build scale on
one card (the builder itself shards over a mesh when given one). Invoke
manually:

    python bench_build.py            # full 10M
    VSTPU_BUILD_N=2000000 python bench_build.py
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

N = int(os.environ.get("VSTPU_BUILD_N", 10_000_000))
DIM = int(os.environ.get("VSTPU_BUILD_DIM", 768))
K = int(os.environ.get("VSTPU_BUILD_K", 4096))


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


from vectorsearch_tpu.utils import enable_compile_cache

enable_compile_cache()


def main():
    from vectorsearch_tpu.build import build_centroids
    from vectorsearch_tpu.quant import layout
    from vectorsearch_tpu.quant.layout import PackedVectors

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((K, DIM), dtype=np.float32)

    t0 = time.perf_counter()
    cache = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        ".cache", f"build-corpus-{N}.npz",
    )
    if os.path.exists(cache):
        z = np.load(cache)
        packed = PackedVectors(
            codes=z["codes"], scale=z["scale"],
            offset=z["offset"], inv_norm=z["inv_norm"],
        )
        log("build-bench: loaded cached packed corpus %s", cache)
    else:
        chunk_rows = 500_000
        # preallocate: a parts list + concatenate would double peak host RSS
        packed = PackedVectors(
            codes=np.empty((N, DIM), np.int8),
            scale=np.empty(N, np.float32),
            offset=np.empty(N, np.float32),
            inv_norm=np.empty(N, np.float32),
        )
        for start in range(0, N, chunk_rows):
            m = min(chunk_rows, N - start)
            block = centers[rng.integers(0, K, size=m)] * np.float32(2.0)
            block += rng.standard_normal((m, DIM), dtype=np.float32)
            part = layout.pack_float(block)
            packed.codes[start : start + m] = part.codes
            packed.scale[start : start + m] = part.scale
            packed.offset[start : start + m] = part.offset
            packed.inv_norm[start : start + m] = part.inv_norm
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(
            cache, codes=packed.codes, scale=packed.scale,
            offset=packed.offset, inv_norm=packed.inv_norm,
        )
        log(
            "build-bench: generated+packed %dx%d in %.1fs (cached -> %s)",
            N, DIM, time.perf_counter() - t0, cache,
        )

    t0 = time.perf_counter()
    result = build_centroids(
        packed,
        k=K,
        min_cluster_size=max(1, (N // K) // 10),
        max_iters=int(os.environ.get("VSTPU_BUILD_ITERS", 8)),
        superset_iters=3,
        chunk=65_536,
        balance_rounds=1,
    )
    build_s = time.perf_counter() - t0
    log(
        "build-bench: %d centroids over %d vectors in %.1fs; "
        "max/mean cluster %d/%d",
        result.centroids.shape[0], N, build_s,
        int(result.counts.max()), int(result.counts.mean()),
    )
    print(
        json.dumps(
            {
                "metric": f"k-means build {N}x{DIM} -> {result.centroids.shape[0]} centroids",
                "value": round(build_s, 1),
                "unit": "s",
            }
        )
    )


if __name__ == "__main__":
    main()
