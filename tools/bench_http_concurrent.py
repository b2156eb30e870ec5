"""Concurrent-HTTP batcher benchmark (VERDICT r4 weak#5).

The reference serves each search on its own goroutine and gets
concurrency from SQL (server/search.go:45,241-273). Here one device runs
one program at a time, so engine/batcher.py coalesces concurrent HTTP
searches into single device dispatches. This tool measures whether that
actually multiplies end-to-end HTTP throughput:

  1. boots the full aiohttp app over a synthetic SQL-populated corpus
     (hermetic: CPU platform, seeded-vector embedder, no network), or
     targets an already-running server with --external URL
  2. sequential baseline: 1 client, S requests -> seq QPS
  3. concurrency sweep: for each client count C, C threads x R requests
     -> QPS, device dispatches (batcher delta via /api/stats), mean
     rows/dispatch
  4. prints ONE JSON line with the sweep table

Hermetic (CPU) and accelerator (VSTPU_HTTPB_DEVICE=1, the default JAX
platform) modes share the same corpus/boot path.

    python tools/bench_http_concurrent.py            # hermetic CPU
    VSTPU_HTTPB_DEVICE=1 python tools/bench_http_concurrent.py  # the card
    python tools/bench_http_concurrent.py --external http://host:port \
        --owner scale --category corpus

Env: VSTPU_HTTPB_N (50000), VSTPU_HTTPB_K (64), VSTPU_HTTPB_CLIENTS
     ("1,8,32"), VSTPU_HTTPB_REQS (total requests per sweep point, 256),
     VSTPU_HTTPB_NPROBE (8), VSTPU_HTTPB_DIM (768)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DIM = int(os.environ.get("VSTPU_HTTPB_DIM", 768))
N = int(os.environ.get("VSTPU_HTTPB_N", 50_000))
K = int(os.environ.get("VSTPU_HTTPB_K", 64))
NPROBE = int(os.environ.get("VSTPU_HTTPB_NPROBE", 8))
REQS = int(os.environ.get("VSTPU_HTTPB_REQS", 256))
CLIENTS = tuple(
    int(c) for c in os.environ.get("VSTPU_HTTPB_CLIENTS", "1,8,32").split(",")
)
TOPK = 10


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def http_json(base, path, payload=None, timeout=600):
    import urllib.request

    if payload is None:
        req = urllib.request.Request(f"{base}{path}")
    else:
        req = urllib.request.Request(
            f"{base}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class SeededAI:
    """Hermetic provider: 'q<i>' embeds to benchmark query i, anything
    else to a seeded random vector (mirrors tools/engine_10m_check.py)."""

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


def boot_hermetic(use_device: bool):
    """Synthetic corpus -> SQL store (with true centroid_id, no rebuild)
    -> Engine -> aiohttp app on an ephemeral port. Returns (base_url,
    engine, cleanup_fn)."""
    if not use_device:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from vectorsearch_tpu.utils import enable_compile_cache

    enable_compile_cache()

    from vectorsearch_tpu.engine import Engine, EngineCache
    from vectorsearch_tpu.quant import codec, layout
    from vectorsearch_tpu.store import Store
    from vectorsearch_tpu.store.db import compress

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    # clustered corpus: K seed directions + noise, so IVF probing is real
    seeds = rng.standard_normal((K, DIM)).astype(np.float32)
    member = rng.integers(0, K, size=N)
    corpus = seeds[member] + 0.3 * rng.standard_normal((N, DIM)).astype(
        np.float32
    )
    packed = layout.pack_float(corpus)
    # centroids = per-cluster means; assignments host-side (exact argmax)
    cents = np.stack(
        [corpus[member == k].mean(0) for k in range(K)]
    ).astype(np.float32)
    cn = cents / np.linalg.norm(cents, axis=1, keepdims=True)
    xn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    assign = np.argmax(xn @ cn.T, axis=1)
    queries = corpus[rng.choice(N, size=256, replace=False)] + 0.1 * (
        rng.standard_normal((256, DIM)).astype(np.float32)
    )
    log("httpb: corpus built (%d x %d, K=%d) in %.1fs", N, DIM, K,
        time.perf_counter() - t0)

    store = Store(":memory:")
    owner = store.get_or_create_owner("scale")
    cat = store.get_or_create_category(owner.id, "corpus")
    cent_wires = [codec.quantize(c).tobytes() for c in cents]
    cent_ids = store.replace_centroids(cat.id, cent_wires, {})
    cent_arr = np.asarray(cent_ids, np.int64)
    empty_doc = compress(b"{}")
    now = time.time()
    t0 = time.perf_counter()
    with store._lock, store._conn:
        cur = store._conn.cursor()
        chunk = 100_000
        for start in range(0, N, chunk):
            m = min(chunk, N - start)
            wires = layout.to_wire(
                layout.take(packed, np.arange(start, start + m))
            )
            cids = cent_arr[assign[start : start + m]]
            cur.executemany(
                "INSERT INTO documents(name, external_id, last_updated, "
                "document, category_id) VALUES ('', '', ?, ?, ?)",
                [(now, empty_doc, cat.id)] * m,
            )
            first = (
                cur.execute("SELECT MAX(id) FROM documents").fetchone()[0]
                - m + 1
            )
            cur.executemany(
                "INSERT INTO embeddings(vector, document_id, centroid_id) "
                "VALUES (?,?,?)",
                [
                    (wires[i].tobytes(), first + i, int(cids[i]))
                    for i in range(m)
                ],
            )
    log("httpb: SQL populated in %.1fs", time.perf_counter() - t0)

    t0 = time.perf_counter()
    eng = Engine(store, SeededAI(queries), cache=EngineCache(ttl=60.0))
    log("httpb: engine boot %.1fs", time.perf_counter() - t0)

    import asyncio

    from aiohttp import web

    from vectorsearch_tpu.api import build_app

    loop = asyncio.new_event_loop()
    holder = {}

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
            holder["port"] = site._server.sockets[0].getsockname()[1]
            holder["runner"] = runner

        loop.run_until_complete(start())
        loop.run_forever()

    threading.Thread(target=run_loop, daemon=True).start()
    while "port" not in holder:
        time.sleep(0.05)
    base = f"http://127.0.0.1:{holder['port']}"
    log("httpb: http on %s", base)

    def cleanup():
        asyncio.run_coroutine_threadsafe(
            holder["runner"].cleanup(), loop
        ).result(30)
        loop.call_soon_threadsafe(loop.stop)
        eng.close()
        store.close()

    return base, eng, cleanup


def batcher_stats(base, eng):
    if eng is not None:
        return eng.stats()["batcher"]
    return http_json(base, "/api/stats")["batcher"]


def run_load(base, owner, category, n_threads, total_reqs, nprobe, eng):
    """n_threads clients issue total_reqs single-query searches; returns
    (qps, dispatches, rows/dispatch, p50_ms, p99_ms)."""
    per = max(1, total_reqs // n_threads)
    total = per * n_threads
    before = batcher_stats(base, eng)
    errors = []
    lats = [[] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads)

    def worker(i):
        try:
            barrier.wait(120)
            for r in range(per):
                t0 = time.perf_counter()
                http_json(base, "/api/search", {
                    "owner": owner, "category": category,
                    "text": f"q{(i * per + r) % 256}",
                    "count": TOPK, "centroids": nprobe,
                })
                lats[i].append(time.perf_counter() - t0)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [
        threading.Thread(target=worker, args=(i,)) for i in range(n_threads)
    ]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        log("httpb: %d errors at C=%d: %s", len(errors), n_threads,
            errors[0])
    after = batcher_stats(base, eng)
    disp = after["dispatches"] - before["dispatches"]
    rows = after["rows_served"] - before["rows_served"]
    flat = np.array([x for l in lats for x in l])
    return {
        "clients": n_threads,
        "requests": total,
        "qps": round(total / dt, 1),
        "dispatches": disp,
        "rows_per_dispatch": round(rows / max(1, disp), 2),
        "p50_ms": round(1000 * float(np.percentile(flat, 50)), 1),
        "p99_ms": round(1000 * float(np.percentile(flat, 99)), 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--external", default=None,
                    help="base URL of a running server (skip hermetic boot)")
    ap.add_argument("--owner", default="scale")
    ap.add_argument("--category", default="corpus")
    args = ap.parse_args()

    use_device = os.environ.get("VSTPU_HTTPB_DEVICE") == "1"
    eng = None
    cleanup = None
    if args.external:
        base = args.external.rstrip("/")
        mode = "external"
    else:
        base, eng, cleanup = boot_hermetic(use_device)
        mode = "device" if use_device else "cpu"

    # warm every batch class at the serving nprobe (a cold class means a
    # mid-traffic compile; Engine.warmup covers (1,8,64,max) classes)
    if eng is not None:
        eng.warmup(nprobes=(NPROBE,))
    http_json(base, "/api/search", {
        "owner": args.owner, "category": args.category, "text": "q0",
        "count": TOPK, "centroids": NPROBE,
    })

    sweep = []
    seq = run_load(base, args.owner, args.category, 1,
                   min(REQS, 128), NPROBE, eng)
    log("httpb: sequential %.1f QPS (p50 %.1fms)", seq["qps"],
        seq["p50_ms"])
    for c in CLIENTS:
        if c == 1:
            sweep.append(seq)
            continue
        r = run_load(base, args.owner, args.category, c, REQS, NPROBE, eng)
        r["speedup_vs_seq"] = round(r["qps"] / seq["qps"], 2)
        log(
            "httpb: C=%d -> %.1f QPS (%.2fx seq), %.2f rows/dispatch, "
            "p50 %.0fms p99 %.0fms",
            c, r["qps"], r["speedup_vs_seq"], r["rows_per_dispatch"],
            r["p50_ms"], r["p99_ms"],
        )
        sweep.append(r)

    out = {
        "mode": mode,
        "n": N if eng is not None else None,
        "nprobe": NPROBE,
        "host_cores": os.cpu_count(),
        "sweep": sweep,
    }
    print(json.dumps(out))
    if cleanup is not None:
        cleanup()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
