"""BASELINE config 5, done properly: the FULL ENGINE serving 10M x 768 on
one chip THROUGH HTTP (VERDICT r2 next-step #1).

Measures, in order:
  1. cold boot   — SQL stream -> pack -> HBM buckets (assignments come
                   from the centroid_id column, no device re-assign)
  2. warm boot   — snapshot-first (index + emb->doc map from one npz)
  3. recall/QPS  — concurrent HTTP /api/search against the exact-f32
                   ground truth over the original corpus (cached by
                   tools/bench_10m_serving.py; same seed-0 generator)
  4. streaming   — HTTP uploads (appends, no rebuild) + deletes, with
                   per-request latency
  5. RSS + device stats from /api/stats

Reuses .cache/build-corpus-10000000.npz + serve10000000-{cents,truth}.npz;
SQL population (one-time, ~10 min host) writes /root/vstpu10m/store.db.

    python tools/engine_10m_check.py
Env: VSTPU_10M_THREADS (64), VSTPU_10M_REQS (20), VSTPU_10M_NPROBE (8),
     VSTPU_10M_SKIP_COLD=1 (reuse existing snapshot, skip cold boot)
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vectorsearch_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

N = int(os.environ.get("VSTPU_10M_N", 10_000_000))
DIM = 768
TOPK = 10
WORK = "/root/vstpu10m"
CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", ".cache")
CORPUS = os.path.join(CACHE_DIR, f"build-corpus-{N}.npz")
CENTS = os.path.join(CACHE_DIR, f"serve{N}-cents.npz")
TRUTH = os.path.join(CACHE_DIR, f"serve{N}-truth.npz")
N_QUERIES = 512


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


class QueryAI:
    """Hermetic provider: 'q<i>' embeds to the i-th benchmark query,
    anything else to a seeded random vector (upload path)."""

    def __init__(self, queries):
        self.queries = queries

    def can_embed(self):
        return True

    def embed(self, inputs, model=None):
        from vectorsearch_tpu.quant import codec

        out = []
        for text in inputs:
            tail = text.rsplit("q", 1)
            if len(tail) == 2 and tail[1].isdigit():
                out.append(codec.quantize(self.queries[int(tail[1])]))
            else:
                rng = np.random.default_rng(abs(hash(text)) % (1 << 32))
                out.append(
                    codec.quantize(rng.standard_normal(DIM).astype(np.float32))
                )
        return out

    def embed_model(self):
        return "q"

    def embed_ctx_num(self):
        return 8192

    def chat_model(self):
        return "q"

    def chat_stream(self, messages, model=None):
        yield ""

    def chat(self, m, model=None):
        return ""

    def generate(self, p, model=None):
        return ""

    def generate_stream(self, p, model=None):
        yield ""


def populate(store, packed, cent_wires, assignments):
    """One-time SQL population: 10M docs + embeddings with the TRUE
    assignment in centroid_id (as a prior rebuild would have left)."""
    from vectorsearch_tpu.quant import layout
    from vectorsearch_tpu.store.db import compress

    t0 = time.perf_counter()
    owner = store.get_or_create_owner("scale")
    cat = store.get_or_create_category(owner.id, "corpus")
    cent_ids = store.replace_centroids(cat.id, cent_wires, {})
    cent_arr = np.asarray(cent_ids, np.int64)
    empty_doc = compress(b"{}")
    chunk = 200_000
    now = time.time()
    with store._lock, store._conn:
        cur = store._conn.cursor()
        for start in range(0, N, chunk):
            m = min(chunk, N - start)
            wires = layout.to_wire(
                layout.take(packed, np.arange(start, start + m))
            )
            cids = cent_arr[assignments[start : start + m]]
            cur.executemany(
                "INSERT INTO documents(name, external_id, last_updated, "
                "document, category_id) VALUES ('', '', ?, ?, ?)",
                [(now, empty_doc, cat.id)] * m,
            )
            first_doc = (
                cur.execute("SELECT MAX(id) FROM documents").fetchone()[0]
                - m + 1
            )
            cur.executemany(
                "INSERT INTO embeddings(vector, document_id, centroid_id) "
                "VALUES (?,?,?)",
                [
                    (wires[i].tobytes(), first_doc + i, int(cids[i]))
                    for i in range(m)
                ],
            )
            if (start // chunk) % 10 == 0:
                log("populate: %d/%d (%.0fs)", start + m, N,
                    time.perf_counter() - t0)
    log("populate: %d rows in %.0fs", N, time.perf_counter() - t0)
    return cat.id


def http_post(port, path, payload, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def main():
    from vectorsearch_tpu.quant import codec, layout
    from vectorsearch_tpu.quant.layout import PackedVectors
    from vectorsearch_tpu.store import Store
    from vectorsearch_tpu.engine import Engine

    for f in (CORPUS, CENTS, TRUTH):
        if not os.path.exists(f):
            log("missing cache %s — run bench_build.py / bench_10m_serving.py first", f)
            return 1
    os.makedirs(WORK, exist_ok=True)
    z = np.load(CORPUS)
    packed = PackedVectors(
        codes=z["codes"], scale=z["scale"], offset=z["offset"],
        inv_norm=z["inv_norm"],
    )
    cz = np.load(CENTS)
    centroids, assignments = cz["centroids"], cz["assignments"]
    truth = np.load(TRUTH)["truth"]
    log("10m-check: caches loaded (K=%d)", len(centroids))

    # queries: must match bench_10m_serving's construction exactly (the
    # cached ground truth is for THESE queries)
    rng = np.random.default_rng(123)
    q_idx = np.sort(rng.choice(N, size=N_QUERIES, replace=False))
    base = (
        packed.offset[q_idx, None]
        + packed.scale[q_idx, None] * packed.codes[q_idx].astype(np.float32)
    )
    queries = base + rng.normal(size=(N_QUERIES, DIM)).astype(np.float32) * 0.1

    db_path = os.path.join(WORK, "store.db")
    fresh = not os.path.exists(db_path)
    store = Store(db_path)
    if fresh:
        cent_wires = [codec.quantize(c).tobytes() for c in centroids]
        populate(store, packed, cent_wires, assignments)
    del packed, z
    cat_row = store.get_category(store.get_owner("scale").id, "corpus")

    snap_dir = os.path.join(WORK, "snaps")
    results = {}

    # ---- cold boot (SQL path) + snapshot save ----
    ai = QueryAI(queries)
    if os.environ.get("VSTPU_10M_SKIP_COLD") == "1" and os.path.isdir(snap_dir):
        log("10m-check: skipping cold boot (reusing snapshot)")
    else:
        t0 = time.perf_counter()
        eng = Engine(store, ai, snapshot_dir=snap_dir)
        results["cold_boot_s"] = round(time.perf_counter() - t0, 1)
        log("10m-check: COLD boot %.1fs", results["cold_boot_s"])
        t0 = time.perf_counter()
        eng.close()  # snapshot already saved from host arrays at boot
        results["snapshot_save_s"] = round(time.perf_counter() - t0, 1)
        log("10m-check: close (clean: no export) %.1fs",
            results["snapshot_save_s"])
        # release the cold engine's device buckets BEFORE the warm boot
        # uploads its own copy: `eng = Engine(...)` evaluates the RHS while
        # the old engine is still referenced (double residency)
        import gc

        eng = None
        gc.collect()

    # ---- warm boot (snapshot-first; VERDICT target < 5 min) ----
    t0 = time.perf_counter()
    eng = Engine(store, ai, snapshot_dir=snap_dir)
    results["warm_boot_s"] = round(time.perf_counter() - t0, 1)
    log("10m-check: WARM boot %.1fs", results["warm_boot_s"])

    # ---- HTTP server on a background loop ----
    import asyncio

    from aiohttp import web

    from vectorsearch_tpu.api import build_app

    loop = asyncio.new_event_loop()
    port_holder = {}

    def run_loop():
        asyncio.set_event_loop(loop)

        async def start():
            app = build_app(eng)
            runner = web.AppRunner(
                app, auto_decompress=False, handler_cancellation=True
            )
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port_holder["port"] = site._server.sockets[0].getsockname()[1]
            port_holder["runner"] = runner

        loop.run_until_complete(start())
        loop.run_forever()

    t = threading.Thread(target=run_loop, daemon=True)
    t.start()
    while "port" not in port_holder:
        time.sleep(0.05)
    port = port_holder["port"]
    log("10m-check: http on :%d", port)

    nprobe = int(os.environ.get("VSTPU_10M_NPROBE", 8))

    # warm the serving shapes at the nprobe we actually serve (first
    # dispatch per (batch-class, nprobe) pair compiles otherwise)
    eng.warmup(nprobes=(nprobe,))
    http_post(port, "/api/search", {
        "owner": "scale", "category": "corpus", "text": "q0",
        "count": TOPK, "centroids": nprobe,
    })

    # ---- recall through HTTP (document id == corpus row + 1) ----
    got = []
    t0 = time.perf_counter()
    for i in range(N_QUERIES):
        resp = http_post(port, "/api/search", {
            "owner": "scale", "category": "corpus", "text": f"q{i}",
            "count": TOPK, "centroids": nprobe,
        })
        got.append([d["document_id"] for d in resp["documents"]])
    seq_ms = 1000 * (time.perf_counter() - t0) / N_QUERIES
    recall = float(np.mean([
        len(set(got[i]) & set((truth[i] + 1).tolist())) / TOPK
        for i in range(N_QUERIES)
    ]))
    results["recall_at_10"] = round(recall, 4)
    results["sequential_ms"] = round(seq_ms, 1)
    log("10m-check: recall@10=%.4f over %d HTTP queries (seq %.0fms each)",
        recall, N_QUERIES, seq_ms)

    # ---- concurrent HTTP load ----
    threads_n = int(os.environ.get("VSTPU_10M_THREADS", 64))
    per_thread = int(os.environ.get("VSTPU_10M_REQS", 20))
    base_stats = eng.stats()["batcher"]
    errors = []
    barrier = threading.Barrier(threads_n)

    def worker(i):
        try:
            barrier.wait(60)
            for r in range(per_thread):
                http_post(port, "/api/search", {
                    "owner": "scale", "category": "corpus",
                    "text": f"q{(i * per_thread + r) % N_QUERIES}",
                    "count": TOPK, "centroids": nprobe,
                })
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads_n)]
    t0 = time.perf_counter()
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    conc_s = time.perf_counter() - t0
    if errors:
        log("10m-check: %d concurrent errors: %s", len(errors), errors[0])
    after = eng.stats()["batcher"]
    total = threads_n * per_thread
    dispatches = after["dispatches"] - base_stats["dispatches"]
    results["http_qps_concurrent"] = round(total / conc_s, 1)
    results["mean_device_batch"] = round(total / max(1, dispatches), 1)
    results["device_dispatches"] = dispatches
    log(
        "10m-check: %d threads x %d reqs -> %.0f HTTP QPS "
        "(%d dispatches, mean batch %.1f)",
        threads_n, per_thread, total / conc_s, dispatches,
        total / max(1, dispatches),
    )

    # ---- batched HTTP load (explicit texts[] batches) ----
    # The single-query concurrent number above is bounded by this VM's
    # one host core (client + aiohttp server + engine Python all share
    # it), not the device. The batched endpoint amortizes the per-request
    # Python cost over 512 queries, so it is the honest way to drive the
    # device near its batched rate THROUGH the HTTP surface.
    bq = int(os.environ.get("VSTPU_10M_BATCH_Q", 512))
    for label, reps, include_docs in (
        ("ids", int(os.environ.get("VSTPU_10M_BATCH_REQS", 20)), False),
        ("docs", int(os.environ.get("VSTPU_10M_BATCH_DOC_REQS", 5)), True),
    ):
        base_stats = eng.stats()["batcher"]
        t0 = time.perf_counter()
        for r in range(reps):
            resp = http_post(port, "/api/search", {
                "owner": "scale", "category": "corpus",
                "texts": [f"q{(r * bq + j) % N_QUERIES}" for j in range(bq)],
                "count": TOPK, "centroids": nprobe,
                "include_documents": include_docs,
            })
            assert len(resp["results"]) == bq
        dt = time.perf_counter() - t0
        after = eng.stats()["batcher"]
        results[f"http_qps_batched_{label}"] = round(reps * bq / dt, 1)
        log(
            "10m-check: batched HTTP (%s, %d reqs x %d queries) -> %.0f QPS "
            "(%d dispatches)",
            label, reps, bq, reps * bq / dt,
            after["dispatches"] - base_stats["dispatches"],
        )

    # ---- streaming inserts + deletes over HTTP ----
    up_lat = []
    new_ids = []
    for i in range(20):
        t0 = time.perf_counter()
        resp = http_post(port, "/api/upload", {
            "owner": "scale", "category": "corpus",
            "documents": [
                {"name": f"live-{i}-{j}", "document": {"t": f"doc {i} {j}"}}
                for j in range(10)
            ],
        })
        up_lat.append(time.perf_counter() - t0)
        new_ids.extend(resp["document_ids"])
    del_lat = []
    for doc_id in new_ids[:20]:
        t0 = time.perf_counter()
        http_post(port, "/api/delete/document", {
            "owner": "scale", "category": "corpus", "document_id": doc_id,
        })
        del_lat.append(time.perf_counter() - t0)
    results["insert_docs_per_s"] = round(
        len(new_ids) / max(1e-9, sum(up_lat)), 1
    )
    results["upload_p50_ms"] = round(1000 * float(np.median(up_lat)), 1)
    results["upload_max_ms"] = round(1000 * float(np.max(up_lat)), 1)
    results["delete_p50_ms"] = round(1000 * float(np.median(del_lat)), 1)
    results["delete_max_ms"] = round(1000 * float(np.max(del_lat)), 1)
    log(
        "10m-check: %d streamed docs (%.0f docs/s, upload p50 %.0fms max "
        "%.0fms); deletes p50 %.0fms max %.0fms",
        len(new_ids), results["insert_docs_per_s"],
        results["upload_p50_ms"], results["upload_max_ms"],
        results["delete_p50_ms"], results["delete_max_ms"],
    )

    stats = json.loads(json.dumps(eng.stats()))  # plain types
    results["host_cores"] = os.cpu_count()
    results["rss_gb"] = round((stats.get("rss_bytes") or 0) / 2**30, 2)
    cat_stats = stats["categories"][str(cat_row.id)] if str(cat_row.id) in stats["categories"] else stats["categories"][cat_row.id]
    results["hbm_gb"] = round(cat_stats["hbm_bytes"] / 2**30, 2)
    results["live_vectors"] = cat_stats["live_vectors"]
    results["spill"] = cat_stats["spill"]
    log("10m-check: rss=%.1f GB, packed index %.1f GB HBM, %d live, %d spill",
        results["rss_gb"], results["hbm_gb"], results["live_vectors"],
        results["spill"])

    print(json.dumps({"n": N, "nprobe": nprobe, **results}))
    asyncio.run_coroutine_threadsafe(
        port_holder["runner"].cleanup(), loop
    ).result(30)
    loop.call_soon_threadsafe(loop.stop)
    # the inserts/deletes made the state dirty; a closing snapshot would
    # device-export 15.5 GB. Skip it:
    # the next boot detects the stale snapshot and falls back to SQL.
    eng.snapshot_dir = None
    eng.close()
    store.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
