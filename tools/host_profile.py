"""Single-query host-path breakdown (VERDICT r3 next-step #6).

The 10M engine served single HTTP queries at 34.6 ms on this 1-core VM
(tools/engine_10m_check.py), honestly diagnosed as host-bound — but the
per-request Python cost was never split. This tool measures the layers:

  1. in-process engine.search, phase-instrumented via monkeypatched
     seams: ai.embed (noop), the batcher dispatch (device), doc_map
     dedup + SQL fetch, and the residual engine bookkeeping;
  2. the HTTP layer on top: aiohttp handler + JSON + socket, measured as
     (sequential HTTP latency) - (in-process latency) on the same corpus.

Runs hermetically on CPU by default (VSTPU_HOSTPROF_DEVICE=1 to use the
default platform — one process per card). The corpus
is synthetic at VSTPU_HOSTPROF_N rows (default 50k: big enough that the
dispatch is visible, small enough to boot in seconds).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("VSTPU_HOSTPROF_DEVICE") != "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

N = int(os.environ.get("VSTPU_HOSTPROF_N", 50_000))
DIM = 512  # the noop embedder's native dim
ROUNDS = int(os.environ.get("VSTPU_HOSTPROF_ROUNDS", 300))
PORT = int(os.environ.get("VSTPU_HOSTPROF_PORT", 7621))


def log(msg, *args):
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def build_engine():
    """Engine with one category of N synthetic rows (packed directly —
    uploading N docs through SQL would dominate the tool's runtime)."""
    os.environ["VSTPU_NOOP_AI"] = "1"
    from vectorsearch_tpu.build import build_centroids
    from vectorsearch_tpu.embed.noop import NoopAI
    from vectorsearch_tpu.engine import Engine, EngineCache
    from vectorsearch_tpu.engine.engine import CategoryState
    from vectorsearch_tpu.index import IVFIndex
    from vectorsearch_tpu.quant import layout
    from vectorsearch_tpu.store import Store

    rng = np.random.default_rng(7)
    data = rng.normal(size=(N, DIM)).astype(np.float32)
    packed = layout.pack_float(data)
    k = max(8, N // 10_000)
    result = build_centroids(packed, k=k, max_iters=4, superset_iters=2)
    ids = np.arange(1, N + 1, dtype=np.int64)
    ivf = IVFIndex.build(
        packed, ids, result.centroids, assignments=result.assignments
    )

    store = Store(":memory:")
    eng = Engine(store, NoopAI(seed=1), cache=EngineCache(ttl=60.0))
    owner = store.get_or_create_owner("o")
    cat = store.get_or_create_category(owner.id, "c")
    # real SQL documents so fetch_documents measures true row reads;
    # embeddings map ~20:1 onto docs (a realistic sections-per-doc ratio
    # — mapping everything onto ONE doc would make every search a
    # pathological deep-pagination escalation, not a representative
    # request)
    n_docs = max(64, N // 20)
    doc_ids = []
    for s in range(0, n_docs, 500):
        doc_ids.extend(
            store.insert_documents(
                cat.id,
                [("d%d" % i, "", {"text": "x%d" % i})
                 for i in range(s, min(s + 500, n_docs))],
            )
        )
    st = CategoryState(category_id=cat.id)
    st.ivf = ivf
    st.doc_map.update(
        (int(e), doc_ids[int(e) % n_docs]) for e in ids
    )
    eng._states[cat.id] = st
    return eng, store, cat


def main():
    eng, store, cat = build_engine()
    log("hostprof: engine ready (N=%d)", N)

    # ---- phase instrumentation -----------------------------------------
    phases = {"embed": 0.0, "dispatch": 0.0}
    from vectorsearch_tpu.engine import engine as engine_mod

    real_embed = eng.ai.embed
    real_submit = eng._batcher.submit

    def timed_embed(*a, **kw):
        t0 = time.perf_counter()
        out = real_embed(*a, **kw)
        phases["embed"] += time.perf_counter() - t0
        return out

    def timed_submit(*a, **kw):
        t0 = time.perf_counter()
        out = real_submit(*a, **kw)
        phases["dispatch"] += time.perf_counter() - t0
        return out

    eng.ai.embed = timed_embed
    eng._batcher.submit = timed_submit

    real_fetch = store.fetch_documents
    phases["sql_fetch"] = 0.0

    def timed_fetch(*a, **kw):
        t0 = time.perf_counter()
        out = real_fetch(*a, **kw)
        phases["sql_fetch"] += time.perf_counter() - t0
        return out

    store.fetch_documents = timed_fetch

    # warm every shape first (compiles excluded from the breakdown)
    eng.search("o", "c", "warm", count=10, centroids=1)
    eng.search("o", "c", "warm", count=10, centroids=8)

    for nprobe in (1, 8):
        for ph in phases:
            phases[ph] = 0.0
        t0 = time.perf_counter()
        for i in range(ROUNDS):
            hits = eng.search("o", "c", f"q{i}", count=10, centroids=nprobe)
            assert hits
        total = time.perf_counter() - t0
        other = total - sum(phases.values())
        log(
            "hostprof: in-process nprobe=%d %.2f ms/query "
            "(embed %.2f, device-dispatch %.2f, sql %.2f, "
            "engine-other %.2f)",
            nprobe, 1000 * total / ROUNDS,
            1000 * phases["embed"] / ROUNDS,
            1000 * phases["dispatch"] / ROUNDS,
            1000 * phases["sql_fetch"] / ROUNDS,
            1000 * other / ROUNDS,
        )

    def inproc_pass():
        t0 = time.perf_counter()
        for i in range(ROUNDS):
            eng.search("o", "c", f"r{i}", count=10, centroids=8)
        return 1000 * (time.perf_counter() - t0) / ROUNDS

    inproc_ms = 1000 * total / ROUNDS  # nprobe=8 figure

    # ---- cProfile the engine-other residue ------------------------------
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for i in range(ROUNDS):
        eng.search("o", "c", f"p{i}", count=10, centroids=8)
    prof.disable()
    stats = pstats.Stats(prof, stream=sys.stderr)
    log("hostprof: top cumulative functions (engine in-process):")
    stats.sort_stats("cumulative").print_stats(18)

    # ---- HTTP layer on top ----------------------------------------------
    import asyncio
    import threading

    from aiohttp import web

    from vectorsearch_tpu.api.http import build_app

    loop = asyncio.new_event_loop()

    def run_loop():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(build_app(eng))
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", PORT)
        loop.run_until_complete(site.start())
        loop.run_forever()

    threading.Thread(target=run_loop, daemon=True).start()
    time.sleep(1.0)

    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", PORT, timeout=30)
    body = json.dumps(
        {"owner": "o", "category": "c", "text": "q", "count": 10,
         "centroids": 8}
    )
    # warm
    conn.request("POST", "/api/search", body)
    conn.getresponse().read()
    # bracket the HTTP loop with fresh in-process passes: the device-side
    # scan keeps warming across the run (caches, allocator state), so the
    # first in-process figure from minutes ago is not a valid baseline —
    # the negative-overhead artifact of the unbracketed version
    pre_ms = inproc_pass()
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        conn.request("POST", "/api/search", body)
        r = conn.getresponse()
        r.read()
        assert r.status == 200
    http_ms = 1000 * (time.perf_counter() - t0) / ROUNDS
    post_ms = inproc_pass()
    base = min(pre_ms, post_ms)
    log(
        "hostprof: HTTP sequential %.2f ms/query vs in-process %.2f/%.2f "
        "(pre/post) -> HTTP layer overhead %.2f ms = aiohttp+json+socket",
        http_ms, pre_ms, post_ms, http_ms - base,
    )
    log("hostprof: done")


if __name__ == "__main__":
    main()
