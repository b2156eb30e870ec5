"""CPU proxy of the reference's divide-and-conquer index builder.

BASELINE.md row 4 demands the device builder be >=10x faster than the Go
builder, but this image has NO Go toolchain (no go, no gccgo frontend) and
no network to fetch one, so the reference cannot be compiled. This proxy
reimplements `dnc.KMeansDivideAndConquer` faithfully in numpy — same
constants, same algorithm, same data flow — and is *conservatively fast*:
every deviation favors the reference, so the measured time is a LOWER
bound on what the Go binary would take:

  * in-memory row arrays instead of temp-file datasets written/re-read at
    every recursion level (dnc/dataset.go:19-56)
  * OpenBLAS multithreaded dgemm vs gonum's single-threaded-per-call
    blas64 (goroutine-level parallelism only)
  * vectorized np.add.at accumulation vs Go's per-row float32 loops
    (dnc/k_means.go:80-86)
  * leaf centroids only (the reference runs kMeans(sample, k=1) at EVERY
    dataset Finalize, internal nodes included — dnc/dataset.go:94-99)

Faithful parts (they define the algorithm's cost and output):
  * u8 wire rows; compute on DEQUANTIZED float64 matrices, both sides
    L2-normalized, C = data @ centroids.T, per-row argmax
    (compute/compute_gonum.go:32-44, cosine_gonum.go:85-113)
  * superset init of k*SUPERSET_MUL unique rows; iterate until the
    quantized centroid bytes stop changing or 1000 iters; truncate to k
    in original order (the counts-zeroed sort bug, k_means.go:111-140)
  * recursion: leaf <= CENTROID_SIZE, else sample 50k -> kMeans
    k=min(5, max(2, total/10k)) -> partition in 10k minibatches
    (dnc/dnc.go:300-400); NumCPU-bounded concurrency (dnc/dnc.go:30-33)
  * full-corpus reassignment in 1000-row batches (dnc/dnc.go:176-263),
    dropSmallCentroids < CENTROID_SIZE/10 (dnc/dnc.go:458-574),
    recenter = quantized member means (dnc/dnc.go:402-456)

    python tools/go_builder_proxy.py                 # 1M x 768
    VSTPU_GOPROXY_N=100000 python tools/go_builder_proxy.py
"""
from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vectorsearch_tpu.quant import codec  # noqa: E402

N = int(os.environ.get("VSTPU_GOPROXY_N", 1_000_000))
DIM = 768
# reference constants (config/constants.go:5-13)
BATCH_SIZE_DATABASE = 1_000
BATCH_SIZE_CACHE = 10_000
CENTROID_SIZE = 10_000
SAMPLE_SIZE = 50_000
SPLIT_SIZE = 5
SUPERSET_MUL = 5
KMEANS_ITERATION_LIMIT = 1_000

_rng = np.random.default_rng(42)


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def dequantize_f64(wire: np.ndarray) -> np.ndarray:
    """u8 wire rows -> float64 matrix (compute/compute_gonum.go:32-44)."""
    return codec.dequantize(wire).astype(np.float64)


def normalize_rows(m: np.ndarray) -> np.ndarray:
    """In-place row L2 normalize (cosine_gonum.go:128-149)."""
    norms = np.linalg.norm(m, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    m /= norms
    return m


def seg_accumulate(sums: np.ndarray, idx: np.ndarray, vec: np.ndarray):
    """sums[idx[i]] += vec[i], via sort+reduceat (much faster than
    np.add.at; speed favors the reference — see module docstring)."""
    order = np.argsort(idx, kind="stable")
    si = idx[order]
    sv = vec[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(si)) + 1])
    sums[si[starts]] += np.add.reduceat(sv, starts, axis=0)


def cosine_argmax(cent_n: np.ndarray, data_u8: np.ndarray) -> np.ndarray:
    """Per-data-row argmax over centroids: dequantize, normalize, one
    dgemm, row argmax (cosine_gonum.go:85-113)."""
    data = normalize_rows(dequantize_f64(data_u8))
    sims = data @ cent_n.T
    return np.argmax(sims, axis=1)


def k_means(data_u8: np.ndarray, k: int) -> np.ndarray:
    """dnc/k_means.go:19-211 on wire rows; returns [k, 8+D] u8.

    Speed deviation (favors the reference): the data side is dequantized
    and L2-normalized ONCE per call; the Go code re-Clones and
    re-normalizes the full 50k x 768 f64 matrix EVERY iteration
    (k_means.go:74-77 -> cosine_gonum.go:85-113)."""
    if k <= 0:
        return data_u8[:0]
    m = len(data_u8)
    if m == 0 or m <= k:
        return data_u8
    data_n = normalize_rows(dequantize_f64(data_u8))  # once, not per iter
    data_f32 = codec.dequantize(data_u8)  # accumulate side (f32, per ref)

    def lloyd(cents_u8: np.ndarray) -> np.ndarray:
        kk = len(cents_u8)
        cents = cents_u8
        for _ in range(KMEANS_ITERATION_LIMIT):
            cent_n = normalize_rows(dequantize_f64(cents))
            sums = np.zeros((kk, DIM), np.float32)
            counts = np.zeros(kk, np.int64)
            for s in range(0, m, BATCH_SIZE_CACHE):
                idx = np.argmax(
                    data_n[s : s + BATCH_SIZE_CACHE] @ cent_n.T, axis=1
                )
                # f32 accumulate of dequantized rows (k_means.go:80-86)
                seg_accumulate(sums, idx, data_f32[s : s + BATCH_SIZE_CACHE])
                counts += np.bincount(idx, minlength=kk)
            means = np.where(
                counts[:, None] > 0,
                sums / np.maximum(counts, 1)[:, None],
                codec.dequantize(cents),
            ).astype(np.float32)
            new_cents = codec.quantize(means)
            # converge when quantized BYTES stop changing (k_means.go:101-108)
            if np.array_equal(new_cents[:, 8:], cents[:, 8:]):
                return new_cents
            cents = new_cents
        return cents

    # superset phase, truncate in original order (counts-zeroed bug)
    ks = min(m, k * SUPERSET_MUL)
    init = _rng.choice(m, size=ks, replace=False)
    cents = lloyd(data_u8[init])[:k]
    # set phase
    return lloyd(cents)


def sample_rows(data_u8: np.ndarray, size: int) -> np.ndarray:
    """Uniform sample without replacement (dnc/sampling.go:15-96)."""
    m = len(data_u8)
    if m <= size:
        return data_u8
    return data_u8[np.sort(_rng.choice(m, size=size, replace=False))]


def divide_and_conquer(data_u8: np.ndarray) -> list[np.ndarray]:
    """dnc/dnc.go:300-400: recursive split, NumCPU-bounded."""
    pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 1)
    out: list[np.ndarray] = []
    futures = []

    def node(rows: np.ndarray):
        total = len(rows)
        if total <= CENTROID_SIZE:
            # leaf centroid: kMeans(sample, k=1) (dataset.go:94-99)
            out.append(k_means(sample_rows(rows, SAMPLE_SIZE), 1)[0])
            return
        samp = sample_rows(rows, SAMPLE_SIZE)
        k = min(SPLIT_SIZE, max(2, total // CENTROID_SIZE))
        cents = k_means(samp, k)
        cent_n = normalize_rows(dequantize_f64(cents))
        assign = np.empty(total, np.int64)
        for s in range(0, total, BATCH_SIZE_CACHE):
            assign[s : s + BATCH_SIZE_CACHE] = cosine_argmax(
                cent_n, rows[s : s + BATCH_SIZE_CACHE]
            )
        for child in range(len(cents)):
            sub = rows[assign == child]
            if len(sub):
                futures.append(pool.submit(node, sub))

    futures.append(pool.submit(node, data_u8))
    while futures:
        futures.pop().result()
    pool.shutdown()
    return out


def main():
    from bench import make_corpus

    t0 = time.perf_counter()
    data = make_corpus(N, DIM, 1024)
    wire = codec.quantize(data)
    del data
    log("goproxy: corpus+quantize %.1fs", time.perf_counter() - t0)

    t_build = time.perf_counter()
    cents = np.stack(divide_and_conquer(wire))
    t_dnc = time.perf_counter() - t_build
    log("goproxy: divide-and-conquer -> %d centroids in %.1fs", len(cents), t_dnc)

    # full reassignment in DB-batch chunks (dnc/dnc.go:176-263)
    cent_n = normalize_rows(dequantize_f64(cents))
    assign = np.empty(N, np.int64)
    for s in range(0, N, BATCH_SIZE_DATABASE):
        assign[s : s + BATCH_SIZE_DATABASE] = cosine_argmax(
            cent_n, wire[s : s + BATCH_SIZE_DATABASE]
        )
    t_assign = time.perf_counter() - t_build - t_dnc
    log("goproxy: reassign %d rows in %.1fs", N, t_assign)

    # dropSmallCentroids (dnc/dnc.go:458-574)
    counts = np.bincount(assign, minlength=len(cents))
    small = counts < CENTROID_SIZE // 10
    if small.any() and (~small).any():
        survivors = cents[~small]
        surv_idx = np.nonzero(~small)[0]
        surv_n = normalize_rows(dequantize_f64(survivors))
        orphans = np.isin(assign, np.nonzero(small)[0])
        rows = wire[orphans]
        re = np.empty(len(rows), np.int64)
        for s in range(0, len(rows), BATCH_SIZE_CACHE):
            re[s : s + BATCH_SIZE_CACHE] = cosine_argmax(
                surv_n, rows[s : s + BATCH_SIZE_CACHE]
            )
        assign[orphans] = surv_idx[re]
        keep = np.nonzero(~small)[0]
        remap = np.full(len(cents), -1, np.int64)
        remap[keep] = np.arange(len(keep))
        assign = remap[assign]
        cents = survivors

    # recenter: quantized member means (dnc/dnc.go:402-456)
    sums = np.zeros((len(cents), DIM), np.float64)
    counts = np.bincount(assign, minlength=len(cents))
    for s in range(0, N, BATCH_SIZE_CACHE):
        seg_accumulate(sums, assign[s : s + BATCH_SIZE_CACHE],
                       dequantize_f64(wire[s : s + BATCH_SIZE_CACHE]))
    means = (sums / np.maximum(counts, 1)[:, None]).astype(np.float32)
    cents = codec.quantize(means)
    total = time.perf_counter() - t_build
    log(
        "goproxy: TOTAL build %.1fs (%d rows -> %d centroids; dnc %.1fs, "
        "reassign %.1fs, drop+recenter %.1fs)",
        total, N, len(cents), t_dnc, t_assign, total - t_dnc - t_assign,
    )
    print(
        {"n": N, "centroids": int(len(cents)), "build_s": round(total, 1)}
    )


if __name__ == "__main__":
    main()
