"""BASELINE config 5 at full scale: 10M x 768 serving QPS/recall on one
card (bench.py stops at 1M).

Reuses the packed corpus cached by bench_build.py, caches centroids and
the exact-f32 ground truth, builds the IVF index with headroom=1.0
(read-heavy: no insert headroom; streaming inserts still work via the
spill tail), and measures the exact serving program (_scan_refined) plus the
flat path for comparison.

Queries are dequantized corpus rows + noise; ground truth is exact-f32
cosine over the ORIGINAL corpus (regenerated slab-by-slab with the same
seed as bench_build), so recall is charged for corpus quantization like
BASELINE configs 2/5 demand.

    python tools/bench_10m_serving.py        # needs bench_build's corpus cache
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vectorsearch_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

N = int(os.environ.get("VSTPU_SERVE10M_N", 10_000_000))
DIM = 768
K = 4096
N_QUERIES = 512
TOPK = 10
CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", ".cache")
CORPUS = os.path.join(CACHE_DIR, f"build-corpus-{N}.npz")
CENTS = os.path.join(CACHE_DIR, f"serve{N}-cents.npz")
TRUTH = os.path.join(CACHE_DIR, f"serve{N}-truth.npz")


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def regen_slabs(chunk_rows=500_000):
    """Replay bench_build.py's generator exactly (seed 0)."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((K, DIM), dtype=np.float32)
    for start in range(0, N, chunk_rows):
        m = min(chunk_rows, N - start)
        block = centers[rng.integers(0, K, size=m)] * np.float32(2.0)
        block += rng.standard_normal((m, DIM), dtype=np.float32)
        yield start, block


def main():
    import jax
    import jax.numpy as jnp

    from vectorsearch_tpu.build import build_centroids
    from vectorsearch_tpu.index import IVFIndex
    from vectorsearch_tpu.index.ivf import _scan_refined
    from vectorsearch_tpu.kernels import cosine
    from vectorsearch_tpu.quant.layout import PackedVectors

    if not os.path.exists(CORPUS):
        log("run bench_build.py first (it caches the packed corpus)")
        return 1
    z = np.load(CORPUS)
    packed = PackedVectors(
        codes=z["codes"], scale=z["scale"], offset=z["offset"],
        inv_norm=z["inv_norm"],
    )
    log("serve10m: loaded packed corpus %s", CORPUS)

    # ---- queries: dequantized corpus rows + noise ----
    rng = np.random.default_rng(123)
    q_idx = np.sort(rng.choice(N, size=N_QUERIES, replace=False))
    base = (
        packed.offset[q_idx, None]
        + packed.scale[q_idx, None] * packed.codes[q_idx].astype(np.float32)
    )
    queries = base + rng.normal(size=(N_QUERIES, DIM)).astype(np.float32) * 0.1

    # ---- centroids (cached) ----
    if os.path.exists(CENTS):
        cz = np.load(CENTS)
        centroids, assignments = cz["centroids"], cz["assignments"]
        log("serve10m: loaded cached centroids (%d)", len(centroids))
    else:
        t0 = time.perf_counter()
        result = build_centroids(
            packed, k=K,
            min_cluster_size=max(1, (N // K) // 10),
            max_iters=8, superset_iters=3, chunk=65_536,
            balance_rounds=3,
        )
        centroids, assignments = result.centroids, result.assignments
        log(
            "serve10m: built %d centroids in %.1fs (max/mean %d/%d)",
            len(centroids), time.perf_counter() - t0,
            int(result.counts.max()), int(result.counts.mean()),
        )
        np.savez(CENTS, centroids=centroids, assignments=assignments)

    # ---- exact f32 ground truth over the ORIGINAL corpus (cached) ----
    # Checkpointed per slab: a crash mid-computation resumes
    # from the last completed slab instead of redoing ~40 min of work.
    truth_part = TRUTH + ".part.npz"
    if os.path.exists(TRUTH):
        truth = np.load(TRUTH)["truth"]
        log("serve10m: loaded cached ground truth")
    else:
        t0 = time.perf_counter()
        qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
        q_dev = jnp.asarray(qn)

        @jax.jit
        def slab_scores(q, slab):
            sn = slab / jnp.linalg.norm(slab, axis=-1, keepdims=True)
            s = jnp.dot(
                q, sn.T,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            return jax.lax.top_k(s, TOPK)

        best_s = np.full((N_QUERIES, TOPK), -np.inf, np.float32)
        best_i = np.zeros((N_QUERIES, TOPK), np.int64)
        done_upto = 0
        # fingerprint ties a checkpoint to its inputs: a stale part file
        # from a different corpus/query config must not silently merge
        fprint = np.asarray(
            [N, N_QUERIES, TOPK, int(os.path.getmtime(CORPUS))], np.int64
        )
        if os.path.exists(truth_part):
            pz = np.load(truth_part)
            if "fprint" in pz.files and np.array_equal(pz["fprint"], fprint):
                best_s, best_i = pz["best_s"], pz["best_i"]
                done_upto = int(pz["done_upto"])
                log("serve10m: resuming ground truth at slab %d", done_upto)
            else:
                log("serve10m: stale truth checkpoint (fingerprint mismatch), restarting")
        for start, block in regen_slabs():
            if start < done_upto:
                continue
            s, i = jax.device_get(slab_scores(q_dev, jnp.asarray(block)))
            i = i.astype(np.int64) + start
            cat_s = np.concatenate([best_s, s], axis=1)
            cat_i = np.concatenate([best_i, i], axis=1)
            take = np.argsort(-cat_s, axis=1)[:, :TOPK]
            best_s = np.take_along_axis(cat_s, take, axis=1)
            best_i = np.take_along_axis(cat_i, take, axis=1)
            tmp = truth_part[:-4] + ".tmp.npz"
            np.savez(tmp, best_s=best_s, best_i=best_i,
                     done_upto=start + len(block), fprint=fprint)
            os.replace(tmp, truth_part)
            log("serve10m: truth slab %d done (%.0fs)", start, time.perf_counter() - t0)
        truth = best_i
        np.savez(TRUTH, truth=truth)
        if os.path.exists(truth_part):
            os.remove(truth_part)
        log("serve10m: ground truth in %.1fs", time.perf_counter() - t0)

    # ---- IVF index (read-only headroom) ----
    t0 = time.perf_counter()
    ids = np.arange(1, N + 1, dtype=np.int64)
    ivf = IVFIndex.build(
        packed, ids, centroids, assignments=assignments, headroom=1.0
    )
    hbm_gb = ivf.k_clusters * ivf.cap * DIM / 1e9
    log(
        "serve10m: bucket pack %.1fs (K=%d cap=%d, codes %.1f GB HBM)",
        time.perf_counter() - t0, ivf.k_clusters, ivf.cap, hbm_gb,
    )
    flat_ids = ivf.ids.reshape(-1)

    results = []

    def measure(label, fn, batch, id_map):
        got = np.empty((N_QUERIES, TOPK), np.int64)
        for i in range(0, N_QUERIES, batch):
            _, idx = fn(jnp.asarray(queries[i : i + batch]))
            got[i : i + batch] = id_map(np.asarray(idx)[: min(batch, N_QUERIES - i)])
        recall = np.mean([
            len(set(got[i]) & set(ids[truth[i]])) / TOPK
            for i in range(N_QUERIES)
        ])
        q_dev = jnp.asarray(np.resize(queries, (batch, DIM)))
        fn(q_dev)[0].block_until_ready()
        rounds = 10
        t0 = time.perf_counter()
        last = None
        for _ in range(rounds):
            last = fn(q_dev)
        last[0].block_until_ready()
        qps = batch * rounds / (time.perf_counter() - t0)
        log("serve10m: %s recall@10=%.4f qps=%.0f (batch %d)",
            label, recall, qps, batch)
        results.append((label, qps, recall))

    # nprobe=64 lists a fallback batch: at the HBM limit the blockexact
    # auto epilogue's extra buffers (block maxima + candidate slab) can
    # push a B=128 compile ~9 MB past the 15.75 GB edge (the engine path
    # handles this with ivf.search's OOM-halving retry; this tool calls
    # _scan_refined directly, so it falls back explicitly)
    for nprobe, batches in ((1, (512,)), (8, (512,)), (64, (128, 64))):
        for batch in batches:
            try:
                measure(
                    f"ivf+refine nprobe={nprobe}"
                    + (f" B={batch}" if batch != batches[0] else ""),
                    lambda q, np_=nprobe: _scan_refined(
                        q, ivf.centroids_n, ivf.buckets, ivf.counts_dev,
                        ivf.bucket_mask, nprobe=np_, k_coarse=32, k=TOPK,
                    ),
                    batch,
                    lambda idx: flat_ids[np.clip(idx, 0, flat_ids.size - 1)],
                )
                break
            except Exception as e:
                log("serve10m: nprobe=%d B=%d failed: %s", nprobe, batch, e)

    # ---- large-batch amortization points (nprobe=1) ----
    # Bigger batches share bucket reads across more DISTINCT queries
    # (the per-dispatch probe/epilogue cost is ~constant in B). Queries
    # must be distinct — np.resize tiling would alias repeats into the
    # same clusters and overstate QPS. Recall is batch-invariant (same
    # program), reused from the nprobe=1 B=512 row. Transient check:
    # the [P + K*QT, cap] score grid grows only 2*B*cap*4 bytes per
    # extra query (the K*QT term dominates at 10M), so B=2048 adds
    # ~126 MB over B=512 — inside the HBM slack next to the 15.5 GB
    # codes (failures are caught and logged, not fatal).
    np1 = next((r for r in results if "nprobe=1" in r[0]), None)
    if np1 is not None:
        rng2 = np.random.default_rng(7)
        pool_max = int(os.environ.get("VSTPU_SERVE10M_BULK_MAX", 8192))
        pool_idx = rng2.choice(N, size=pool_max, replace=False)
        base2 = (
            packed.offset[pool_idx, None]
            + packed.scale[pool_idx, None]
            * packed.codes[pool_idx].astype(np.float32)
        )
        q_pool = (
            base2 + rng2.normal(size=(pool_max, DIM)).astype(np.float32) * 0.1
        ).astype(np.float32)
        # each doubling adds ~2*B*cap*4 bytes of score grid (~42 MB per
        # 1024 queries at cap=5120); 8192 is ~335 MB over B=512 — inside
        # the slack next to the 15.5 GB codes, and a failure just logs
        # filter, don't clamp: q_pool[:b] past pool_max would silently
        # dispatch fewer rows than the QPS math divides by
        for batch in sorted({b for b in (2048, 4096, 8192) if b <= pool_max}):
            try:
                fn = lambda q: _scan_refined(  # noqa: E731
                    q, ivf.centroids_n, ivf.buckets, ivf.counts_dev,
                    ivf.bucket_mask, nprobe=1, k_coarse=32, k=TOPK,
                )
                q_dev = jnp.asarray(q_pool[:batch])
                fn(q_dev)[0].block_until_ready()
                rounds = 10
                t0 = time.perf_counter()
                last = None
                for _ in range(rounds):
                    last = fn(q_dev)
                last[0].block_until_ready()
                qps = batch * rounds / (time.perf_counter() - t0)
                log(
                    "serve10m: ivf+refine nprobe=1 B=%d qps=%.0f "
                    "(recall reused from B=512: %.4f)", batch, qps, np1[2],
                )
                results.append(
                    (f"ivf+refine nprobe=1 B={batch}", qps, np1[2])
                )
            except Exception as e:
                log("serve10m: nprobe=1 B=%d failed: %s", batch, e)

    # exhaustive exact scan over the RESIDENT bucket store (streamed
    # dynamic-slice walk, index/ivf._exhaustive_refined). The r1-r4
    # formulation uploaded a SECOND full corpus copy (7.7 GB packed)
    # next to the 15.5 GB index and scan_topk's pad+retile added a third
    # — that is what OOM'd here (VERDICT r4 weak#4). The streamed path
    # adds no resident HBM: one [chunk, D] staging tile per step.
    from vectorsearch_tpu.index.ivf import _exhaustive_refined

    for label in ("flat+refine streamed B=512",):
        try:
            measure(
                label,
                lambda q: _exhaustive_refined(
                    q, ivf.buckets, ivf.bucket_mask, k_coarse=32, k=TOPK,
                    refine=True,
                ),
                512,
                lambda idx: flat_ids[np.clip(idx, 0, flat_ids.size - 1)],
            )
        except Exception as e:
            log("serve10m: %s failed: %s", label, e)

    eligible = [r for r in results if r[2] >= 0.9] or results
    label, qps, recall = max(eligible, key=lambda r: r[1])
    print(json.dumps({
        "metric": f"QPS at recall@10, {N}x{DIM} int8 IVF serving ({label}, recall={recall:.4f})",
        "value": round(qps, 1),
        "unit": "qps",
        "rows": [
            {"label": l, "qps": round(q, 1), "recall": round(r, 4)}
            for l, q, r in results
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
