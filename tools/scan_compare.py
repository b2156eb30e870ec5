"""Time the three IVF bucket-scan formulations through IVFIndex.search.

    python tools/scan_compare.py [--k 1000] [--cap 3072] [--dim 768]

(a) kernel    the grouped scan as the Pallas/Triton kernel
              (vectorsearch_tpu/kernels/bucket_scan.py)
(b) grouped   the same grouping in plain JAX: jnp.take of each group's
              bucket + batched dot_general (tests/scan_reference.py)
(c) per-pair  one gathered bucket copy per (query, probe) pair
              (tests/scan_reference.py)

Each is swapped into IVFIndex.search(refine=64) in turn on one index and
timed at nprobe 1, 8 and 64 (B=512) with the compile outside the window.
The index has the 1M x 768 corpus's shape (K=1000 buckets of 3072 slots,
~1M live rows) with codes drawn on the device; the timing depends on the
shapes and the probe spread, and correctness is checked elsewhere (the
tests and chip_smoke.py). Prints one JSON line per measurement with the
bucket-code bytes each formulation moves, then what XLA lowered the
s8 x s8 -> s32 `scores_int8` product to. Needs an accelerator.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--cap", type=int, default=3072)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="allow the CPU (a tiny dry run; prints no card)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from vectorsearch_tpu.utils import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform == "cpu" and not args.rehearse:
        log("scan_compare: no accelerator")
        return 2
    import scan_reference

    from vectorsearch_tpu.index import FlatIndex, IVFIndex
    from vectorsearch_tpu.kernels import bucket_scan, cosine
    from vectorsearch_tpu.quant import layout

    if not args.rehearse:
        print(card(), flush=True)
    kk, cap, d = args.k, args.cap, args.dim
    keys = jax.random.split(jax.random.PRNGKey(args.seed), 5)
    rng = np.random.default_rng(args.seed)
    counts = rng.integers(cap * 2 // 3, cap + 1, kk).astype(np.int32)
    mask = np.arange(cap)[None, :] < counts[:, None]
    codes = jax.random.randint(keys[0], (kk, cap, d), -127, 128, jnp.int32)
    codes = codes.astype(jnp.int8)
    scale = jax.random.uniform(keys[1], (kk, cap), minval=0.02, maxval=0.05)
    offset = jax.random.normal(keys[2], (kk, cap)) * 0.01
    inv_norm = 1.0 / (scale * 73.9 + 1e-3)  # ~1/||v|| of uniform codes
    cents = jax.random.normal(keys[3], (kk, d))
    ivf = IVFIndex(
        centroids=cents, centroids_n=cosine.l2_normalize(cents),
        buckets=layout.PackedVectors(codes, scale, offset, inv_norm),
        bucket_mask=jnp.asarray(mask), mask_host=mask, counts=counts,
        counts_dev=jnp.asarray(counts),
        ids=np.arange(kk * cap, dtype=np.int64).reshape(kk, cap),
        spill=FlatIndex.create(d), live_count=int(counts.sum()),
    )
    queries = np.asarray(jax.random.normal(keys[4], (args.batch, d)))
    qn = cosine.l2_normalize(jnp.asarray(queries))
    log("index K=%d cap=%d live=%d", kk, cap, ivf.live_count)

    impls = ("kernel", "grouped", "per-pair")
    real_scores = bucket_scan.grouped_scores
    real_scan = bucket_scan.grouped_scan
    real_transient = bucket_scan.transient_bytes

    def install(name):
        bucket_scan.grouped_scores = real_scores
        bucket_scan.grouped_scan = real_scan
        bucket_scan.transient_bytes = real_transient
        if name == "grouped":
            bucket_scan.grouped_scores = scan_reference.grouped_scores_xla
            bucket_scan.transient_bytes = lambda b, p, kk_, cap_: (
                real_transient(b, p, kk_, cap_)
                + (b * p // 16 + min(kk_, b * p)) * cap_ * d * 3
            )
        elif name == "per-pair":
            bucket_scan.grouped_scan = scan_reference.per_pair_scan
            bucket_scan.transient_bytes = (
                lambda b, p, kk_, cap_: scan_reference.per_pair_transient_bytes(
                    b, p, kk_, cap_, d
                )
            )
        jax.clear_caches()

    q = np.asarray(queries, np.float32)
    results = {}
    for name in impls:
        install(name)
        for nprobe in (1, 8, 64):
            faulthandler.dump_traceback_later(300, exit=True, file=sys.stdout)
            t0 = time.perf_counter()
            s, ids = ivf.search(q, k=64, nprobe=nprobe, refine=64)
            compile_s = time.perf_counter() - t0
            times = []
            for _ in range(args.rounds if name != "per-pair" else 3):
                t0 = time.perf_counter()
                ivf.search(q, k=64, nprobe=nprobe, refine=64)
                times.append(time.perf_counter() - t0)
            faulthandler.cancel_dump_traceback_later()
            # distinct probed clusters -> bucket bytes read once per group
            _, probed = cosine.topk(
                jnp.dot(qn.astype(jnp.bfloat16),
                        ivf.centroids_n.astype(jnp.bfloat16).T,
                        preferred_element_type=jnp.float32), nprobe)
            probed = np.asarray(probed)
            p = probed.size
            qt = bucket_scan.group_size(p, kk)
            _, counts_c = np.unique(probed, return_counts=True)
            n_groups = int(np.sum(-(-counts_c // qt)))
            code_bytes = {
                "kernel": n_groups * cap * d,
                "grouped": n_groups * cap * d * 6,  # take w+r, bf16 w+r
                "per-pair": p * cap * d * 6,
            }[name]
            row = {
                "impl": name, "nprobe": nprobe, "batch": len(q),
                "ms_per_batch_median": float(np.median(times) * 1e3),
                "ms_per_batch_min": float(np.min(times) * 1e3),
                "first_call_s": compile_s,
                "groups": n_groups, "qt": qt, "code_bytes": code_bytes,
                "K": kk, "cap": cap,
            }
            results[(name, nprobe)] = ids
            print(json.dumps(row), flush=True)
    for nprobe in (1, 8, 64):
        base = results[("per-pair", nprobe)]
        for name in ("kernel", "grouped"):
            same = float(np.mean(results[(name, nprobe)][:, :10] == base[:, :10]))
            print(json.dumps({"ids_equal_to_per_pair": name, "nprobe": nprobe,
                              "fraction": same}), flush=True)
    # kernel launch shapes at nprobe=8: (tile, bk, warps, stages)
    install("kernel")
    for cfg in ((128, 128, 4, 3), (64, 128, 4, 3), (128, 64, 4, 4),
                (128, 128, 8, 3), (256, 64, 8, 3)):
        (bucket_scan.TILE_MAX, bucket_scan.BK_MAX, bucket_scan.NUM_WARPS,
         bucket_scan.NUM_STAGES) = cfg
        jax.clear_caches()
        faulthandler.dump_traceback_later(200, exit=True, file=sys.stdout)
        try:
            ivf.search(q, k=64, nprobe=8, refine=64)
            times = []
            for _ in range(args.rounds):
                t0 = time.perf_counter()
                ivf.search(q, k=64, nprobe=8, refine=64)
                times.append(time.perf_counter() - t0)
            print(json.dumps({"kernel_cfg": cfg, "nprobe": 8,
                              "ms_per_batch_median": float(np.median(times) * 1e3)}),
                  flush=True)
        except Exception as e:  # a launch shape the compiler refuses
            print(json.dumps({"kernel_cfg": cfg, "error": str(e)[:300]}), flush=True)
        faulthandler.cancel_dump_traceback_later()
    (bucket_scan.TILE_MAX, bucket_scan.BK_MAX, bucket_scan.NUM_WARPS,
     bucket_scan.NUM_STAGES) = (128, 128, 4, 3)
    jax.clear_caches()

    # what the s8 x s8 -> s32 product of the flat scan lowers to
    qc = jnp.zeros((256, d), jnp.int8)
    corpus_pv = layout.PackedVectors(
        codes=ivf.buckets.codes.reshape(-1, d)[:65_536],
        scale=ivf.buckets.scale.reshape(-1)[:65_536],
        offset=ivf.buckets.offset.reshape(-1)[:65_536],
        inv_norm=ivf.buckets.inv_norm.reshape(-1)[:65_536],
    )
    f = jax.jit(cosine.scores_int8)
    args_ = (qc, jnp.ones(256), jnp.ones(256), corpus_pv)
    hlo = f.lower(*args_).compile().as_text()
    lines = [
        ln.strip()[:200] for ln in hlo.splitlines()
        if ("custom_call_target" in ln or "fusion(" in ln or " dot(" in ln)
        and "ENTRY" not in ln
    ]
    print(json.dumps({"scores_int8_hlo": lines[:12]}), flush=True)
    f(*args_).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(20):
        out = f(*args_)
    out.block_until_ready()
    print(json.dumps({"scores_int8_ms_256x65536x768":
                      (time.perf_counter() - t0) / 20 * 1e3}), flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(json.dumps({"peak_bytes_in_use": stats.get("peak_bytes_in_use")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
