"""Smoke run of the served search path on one NVIDIA GPU.

    python chip_smoke.py [--seed 0]      # one card: 1M x 768 through Engine
    python chip_smoke.py --four          # four cards: sharded serving, 4M x 768

One card. A 1,000,000 x 768 clustered float32 corpus (1000 generator
centers, from --seed) is written as wire-format rows into a SQLite store,
then driven through the entry points a deployment calls:

  boot      Engine(store, embedder): SQL stream -> pack -> device IVF buckets
  kernel    the compiled bucket-scan kernel against a numpy reference
  rebuild   Engine.refresh_category: on-device k-means, index swap
  search    64 held-out queries through Engine.search at centroids 1, 8, -1,
            sequentially and from 32 threads (the batcher coalesces them)
  mutate    100 streaming uploads (no rebuild), one found by its own vector,
            one document deleted and gone
  http      the same Engine behind api.build_app: /api/search, /api/categories

Correctness is checked against numpy float64 brute force over the
dequantized stored corpus (ids at centroids=-1, refined scores within
1e-4) and over the original float32 corpus (recall@10 >= 0.95 at
centroids=8). With --four, ShardedIVF over four cards is compared with a
single-device IVFIndex on the same data, and nothing else runs.

Every phase prints its seconds, the device's peak memory and the card's
name and power limit; the last line is one JSON object naming the device.
Needs a GPU: on any other platform it exits non-zero with no result.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from vectorsearch_tpu.utils import enable_compile_cache  # noqa: E402

OWNER, CATEGORY = "smoke", "corpus"
TOPK = 10


def check(ok, msg="") -> None:
    """A correctness bound of the smoke run (kept under python -O)."""
    if not ok:
        raise AssertionError(msg)


# ------------------------------------------------------------------ data


def make_corpus(n: int, dim: int, k: int, seed: int, n_queries: int = 64):
    """Clustered float32 corpus around k generator centers, plus held-out
    queries from the same distribution. Returns (centers, assign, data,
    queries)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim), dtype=np.float32)
    assign = rng.integers(0, k, size=n)
    data = np.empty((n, dim), np.float32)
    for s in range(0, n, 100_000):
        e = min(s + 100_000, n)
        data[s:e] = centers[assign[s:e]] * np.float32(2.0)
        data[s:e] += rng.standard_normal((e - s, dim), dtype=np.float32)
    q_assign = rng.integers(0, k, size=n_queries)
    queries = centers[q_assign] * np.float32(2.0) + rng.standard_normal(
        (n_queries, dim), dtype=np.float32
    )
    return centers, assign, data, queries


def dequantize_wire(wire: np.ndarray) -> np.ndarray:
    """Wire rows [8-byte f32 min/max header | D uint8] -> float64 vectors
    (min + q/255 * (max - min)), written out here, apart from the code
    under test."""
    wire = np.ascontiguousarray(wire, np.uint8)
    header = wire[:, :8].view("<f4").astype(np.float64)
    q = wire[:, 8:].astype(np.float64)
    return header[:, :1] + q / 255.0 * (header[:, 1:2] - header[:, :1])


class SeededEmbedder:
    """Embedding provider with fixed vectors: an input containing
    "q <i>" embeds to query i, "new <j>" to new document j."""

    _TOKEN = re.compile(r"\b(q|new) (\d+)\b")

    def __init__(self, queries: np.ndarray, new_docs: np.ndarray):
        from vectorsearch_tpu.quant import codec

        self.wires = {"q": codec.quantize(queries), "new": codec.quantize(new_docs)}

    def can_embed(self):
        return True

    def embed(self, inputs, model=None):
        out = []
        for text in inputs:
            kind, i = self._TOKEN.search(text).groups()
            out.append(self.wires[kind][int(i)])
        return out

    def embed_model(self):
        return "seeded"

    def embed_ctx_num(self):
        return 8192

    def chat_model(self):
        return "seeded"

    def chat_stream(self, messages, model=None):
        yield ""

    def generate(self, p, model=None):
        return ""

    def generate_stream(self, p, model=None):
        yield ""

    def chat(self, m, model=None):
        return ""


def populate_store(store, wires: np.ndarray, centers: np.ndarray, assign):
    """Write the corpus as past uploads would have left it: one document
    per row (document id = row + 1), its wire embedding, and the
    generator centers as the category's centroids."""
    from vectorsearch_tpu.quant import codec
    from vectorsearch_tpu.store.db import compress

    owner = store.get_or_create_owner(OWNER)
    cat = store.get_or_create_category(owner.id, CATEGORY)
    cent_ids = store.replace_centroids(
        cat.id, [codec.quantize(c).tobytes() for c in centers], {}
    )
    empty_doc = compress(b"{}")
    now = time.time()
    n = len(wires)
    with store._lock, store._conn:
        cur = store._conn.cursor()
        for s in range(0, n, 100_000):
            e = min(s + 100_000, n)
            cur.executemany(
                "INSERT INTO documents(id, name, external_id, last_updated, "
                "document, category_id) VALUES (?, ?, '', ?, ?, ?)",
                [(i + 1, f"row {i}", now, empty_doc, cat.id) for i in range(s, e)],
            )
            cur.executemany(
                "INSERT INTO embeddings(id, vector, document_id, centroid_id) "
                "VALUES (?, ?, ?, ?)",
                [
                    (i + 1, wires[i].tobytes(), i + 1, cent_ids[assign[i]])
                    for i in range(s, e)
                ],
            )
    return cat.id


# ------------------------------------------------------------- reference


def exact_topk(corpus: np.ndarray, queries: np.ndarray, k: int = TOPK):
    """float64 brute-force cosine top-k: (scores [Q, k], rows [Q, k])."""
    qn = np.asarray(queries, np.float64)
    qn = qn / np.linalg.norm(qn, axis=1, keepdims=True)
    best_s = np.full((len(qn), 0), -np.inf)
    best_i = np.zeros((len(qn), 0), np.int64)
    for s in range(0, len(corpus), 100_000):
        block = np.asarray(corpus[s : s + 100_000], np.float64)
        sims = qn @ (block / np.linalg.norm(block, axis=1, keepdims=True)).T
        cand_s = np.concatenate([best_s, sims], axis=1)
        cand_i = np.concatenate(
            [best_i, np.broadcast_to(np.arange(s, s + len(block)), sims.shape)],
            axis=1,
        )
        top = np.argsort(-cand_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(cand_s, top, axis=1)
        best_i = np.take_along_axis(cand_i, top, axis=1)
    return best_s, best_i


def cosine_rows(corpus: np.ndarray, queries: np.ndarray, rows: np.ndarray):
    """float64 cosine of query i with corpus rows[i, :]."""
    qn = np.asarray(queries, np.float64)
    qn = qn / np.linalg.norm(qn, axis=1, keepdims=True)
    v = np.asarray(corpus[rows], np.float64)
    v = v / np.linalg.norm(v, axis=2, keepdims=True)
    return np.einsum("qd,qkd->qk", qn, v)


def check_exact(hits_rows, hit_scores, ref_s, ref_i, stored, queries):
    """Engine results at centroids=-1 against the stored-corpus reference:
    the reference's ids (a swap is allowed only between reference scores
    within 1e-6 of each other) and refined scores within 1e-4."""
    got = np.asarray(hits_rows)
    check(got.shape == ref_i.shape, (got.shape, ref_i.shape))
    got_ref_s = cosine_rows(stored, queries, got)
    tie = ref_s[:, -1:] - 1e-6
    mismatch = (got != ref_i) & ~(np.abs(got_ref_s - ref_s) < 1e-6)
    check(
        not mismatch.any(),
        f"ids differ from the reference at {np.argwhere(mismatch)[:5]}",
    )
    check((got_ref_s >= tie).all())
    err = float(np.max(np.abs(np.asarray(hit_scores) - got_ref_s)))
    check(err <= 1e-4, f"refined scores off the reference by {err}")
    return err


def recall_at_k(hits_rows, truth_rows) -> float:
    return float(np.mean([
        len(set(map(int, a)) & set(map(int, b))) / truth_rows.shape[1]
        for a, b in zip(hits_rows, truth_rows)
    ]))


# ---------------------------------------------------------------- phases


def phase_boot(store, embedder):
    from vectorsearch_tpu.engine import Engine

    eng = Engine(store, embedder)
    st = eng.stats()["categories"]
    (cat,) = st.values()
    return eng, cat


def phase_kernel(ivf, queries: np.ndarray, nprobe: int = 8) -> float:
    """The bucket-scan kernel as compiled for this device on the live
    index, against numpy on every row the search reads. Returns the
    largest absolute score difference."""
    import jax
    import jax.numpy as jnp

    from vectorsearch_tpu.index.ivf import _probe
    from vectorsearch_tpu.kernels import bucket_scan, cosine

    qn = cosine.l2_normalize(jnp.asarray(queries, jnp.float32))
    probed = _probe(qn, ivf.centroids_n, nprobe)
    kk, cap = ivf.k_clusters, ivf.cap
    qt = bucket_scan.group_size(probed.size, kk)
    grp, qidx, pair_slot, n_groups = bucket_scan.build_groups(probed, kk, qt)
    qg = qn.astype(jnp.bfloat16)[qidx]
    qsum_g = jnp.sum(qn, axis=-1)[qidx]
    a, bv, bias = bucket_scan.row_terms(ivf.buckets, ivf.counts_dev, ivf.bucket_mask)
    out = bucket_scan.grouped_scores(
        qg, qsum_g, grp, n_groups, ivf.buckets.codes, a, bv, bias,
        interpret=bucket_scan._interpret(),
    )
    out, grp, qg, qsum_g, pair_slot, n_groups = jax.device_get(
        (out, grp, qg, qsum_g, pair_slot, n_groups)
    )
    used = sorted({int(r) // qt for r in pair_slot})
    check(len(used) == int(n_groups))
    worst = 0.0
    for g in used[:: max(1, len(used) // 16)]:  # 16 groups spread over all
        c = int(grp[g])
        codes = np.asarray(ivf.buckets.codes[c], np.float64)  # [cap, D]
        dots = np.asarray(qg[g], np.float64) @ codes.T  # [QT, cap]
        a_c, bv_c, bias_c = (np.asarray(x[c], np.float64) for x in (a, bv, bias))
        want = dots * a_c + np.asarray(qsum_g[g], np.float64)[:, None] * bv_c + bias_c
        got = np.asarray(out[g], np.float64)
        check((np.isneginf(got) == np.isneginf(want)).all())
        live = np.isfinite(want)
        worst = max(worst, float(np.max(np.abs(got[live] - want[live]), initial=0)))
    check(worst <= 1e-4, f"kernel off the numpy reference by {worst}")
    return worst


def phase_rebuild(eng, cat_id: int, k: int) -> dict:
    """k-means rebuild to k clusters of ~n/k rows (clusters under a tenth
    of that are dropped and their rows reassigned)."""
    n = eng.stats()["categories"][cat_id]["live_vectors"]
    check(eng.refresh_category(
        cat_id, k=k, min_cluster_size=max(1, n // k // 10), max_iters=20,
        superset_iters=4, chunk=65_536,
    ), "rebuild did not run")
    return eng.stats()["categories"][cat_id]


def search_rows(eng, texts, centroids: int, threads: int = 0):
    """Engine.search for each text; (rows [Q, 10], scores [Q, 10]) with
    row = document id - 1, plus the batcher's rows per dispatch."""
    before = eng.stats()["batcher"]
    out = [None] * len(texts)

    def one(i):
        hits = eng.search(OWNER, CATEGORY, texts[i], count=TOPK, centroids=centroids)
        out[i] = ([h.document_id - 1 for h in hits], [h.similarity for h in hits])

    if threads:
        todo = list(range(len(texts)))
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    if not todo:
                        return
                    i = todo.pop()
                one(i)

        ts = [threading.Thread(target=worker) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    else:
        for i in range(len(texts)):
            one(i)
    after = eng.stats()["batcher"]
    rows_per_dispatch = (after["rows_served"] - before["rows_served"]) / max(
        1, after["dispatches"] - before["dispatches"]
    )
    check(all(len(r[0]) == TOPK for r in out), "short result page")
    return (
        np.asarray([r[0] for r in out]), np.asarray([r[1] for r in out]),
        rows_per_dispatch,
    )


def phase_search(eng, n_queries, stored, original, queries, threads=32):
    """Returns a dict of per-centroids results; raises on any bound."""
    texts = [f"q {i}" for i in range(n_queries)]
    wire_q = SeededEmbedder(queries, queries[:1]).wires["q"]
    q_engine = dequantize_wire(wire_q)  # the query as the engine sees it
    ref_s, ref_i = exact_topk(stored, q_engine)
    _, truth = exact_topk(original, queries)
    report = {}
    for centroids in (1, 8, -1):
        rows, scores, seq_rpd = search_rows(eng, texts, centroids)
        rows_c, scores_c, conc_rpd = search_rows(eng, texts, centroids, threads)
        check(np.array_equal(rows, rows_c), "concurrent results differ")
        np.testing.assert_allclose(scores, scores_c, atol=1e-6)
        entry = {
            "recall_at_10_vs_f32": recall_at_k(rows, truth),
            "rows_per_dispatch_sequential": seq_rpd,
            "rows_per_dispatch_32_threads": conc_rpd,
        }
        if centroids == -1:
            entry["max_score_err_vs_f64"] = check_exact(
                rows, scores, ref_s, ref_i, stored, q_engine
            )
        report[centroids] = entry
    check(report[8]["recall_at_10_vs_f32"] >= 0.95, report[8])
    return report


def phase_mutate(eng, n_new: int, n_rows: int) -> dict:
    docs = [{"name": f"new-{j}", "document": {"text": f"new {j}"}} for j in range(n_new)]
    ids = eng.upload(OWNER, CATEGORY, docs)
    check(len(ids) == n_new and min(ids) > n_rows)
    st = eng._state_for(eng.store.get_category(
        eng.store.get_owner(OWNER).id, CATEGORY).id, create=False)
    check(st.sharded is None and st.ivf.n_live == n_rows + n_new)
    probe = n_new // 2
    hits = eng.search(OWNER, CATEGORY, f"new {probe}", count=TOPK, centroids=8)
    check(hits[0].document_id == ids[probe], "inserted document not first")
    gone = ids[probe]
    eng.delete_document(OWNER, CATEGORY, gone)
    hits = eng.search(OWNER, CATEGORY, f"new {probe}", count=TOPK, centroids=8)
    check(gone not in [h.document_id for h in hits], "deleted document returned")
    hits = eng.search(OWNER, CATEGORY, f"new {probe}", count=TOPK, centroids=-1)
    check(gone not in [h.document_id for h in hits], "deleted document returned")
    return {"inserted": n_new, "found_first": True, "deleted_gone": True}


def phase_http(eng) -> dict:
    """Serve the booted Engine in this process through api.build_app and
    call it with urllib."""
    import asyncio
    import urllib.request

    from aiohttp import web

    from vectorsearch_tpu.api import build_app

    ready = threading.Event()
    state = {}

    def serve():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(build_app(eng), auto_decompress=False)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        state["port"] = runner.addresses[0][1]
        state["loop"], state["runner"] = loop, runner
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    check(ready.wait(60), "HTTP server did not start")

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{state['port']}{path}",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            check(r.status == 200)
            return json.loads(r.read())

    try:
        res = post("/api/search", {
            "owner": OWNER, "category": CATEGORY, "text": "q 0",
            "count": TOPK, "centroids": 8,
        })
        direct = eng.search(OWNER, CATEGORY, "q 0", count=TOPK, centroids=8)
        check([d["document_id"] for d in res["documents"]] == [
            h.document_id for h in direct
        ], "HTTP search differs from Engine.search")
        cats = post("/api/categories", {"owner": OWNER})
        check(cats["category_names"] == [CATEGORY], cats)
    finally:
        state["loop"].call_soon_threadsafe(state["loop"].stop)
        t.join(60)
    return {"search_hits": len(res["documents"]), "categories": cats["category_names"]}


def phase_four(n: int, dim: int, k: int, seed: int, n_queries: int = 64) -> dict:
    """ShardedIVF over four devices vs a single-device IVFIndex on the same
    data: equal ids at nprobe=8 with refine, scores within 1e-4, buckets
    on four distinct devices."""
    import jax

    from vectorsearch_tpu.index import IVFIndex
    from vectorsearch_tpu.index.ivf import assign_clusters
    from vectorsearch_tpu.parallel import ShardedIVF, default_mesh
    from vectorsearch_tpu.quant import layout

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim), dtype=np.float32)
    packed = layout.PackedVectors(
        np.empty((n, dim), np.int8), np.empty(n, np.float32),
        np.empty(n, np.float32), np.empty(n, np.float32),
    )
    for s in range(0, n, 500_000):
        m = min(500_000, n - s)
        block = centers[rng.integers(0, k, m)] * np.float32(2.0)
        block += rng.standard_normal((m, dim), dtype=np.float32)
        for dst, src in zip(packed, layout.pack_float(block)):
            dst[s : s + m] = src
    queries = centers[rng.integers(0, k, n_queries)] * np.float32(2.0) + (
        rng.standard_normal((n_queries, dim), dtype=np.float32)
    )
    ids = np.arange(1, n + 1, dtype=np.int64)
    assignments = assign_clusters(packed, centers)
    mesh = default_mesh(4)
    sharded = ShardedIVF.build(mesh, packed, ids, centers, assignments=assignments)
    devices = {sh.device for sh in sharded.buckets.codes.addressable_shards}
    check(len(devices) == 4, devices)
    single = IVFIndex.build(packed, ids, centers, assignments=assignments)
    del packed
    s1, i1 = single.search(queries, k=TOPK, nprobe=8, refine=64)
    s4, i4 = sharded.search(queries, k=TOPK, nprobe=8, refine=64)
    check(np.array_equal(i1, i4), "sharded ids differ from one device")
    err = float(np.max(np.abs(s1 - s4)))
    check(err <= 1e-4, f"sharded scores off by {err}")
    return {
        "devices": sorted(str(d) for d in devices), "n": n, "k": k,
        "ids_equal": True, "max_score_diff": err,
        "count": len(jax.devices()),
    }


# ------------------------------------------------------------------ main


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Phases:
    """Runs named phases, printing seconds, peak device memory and the
    card per phase. A failing phase propagates (exit non-zero)."""

    def __init__(self, device, card_line: str):
        self.device, self.card = device, card_line

    def run(self, name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        peak = (self.device.memory_stats() or {}).get("peak_bytes_in_use")
        print(
            f"phase {name}: {dt:.2f} s, peak_bytes_in_use {peak}, card {self.card}"
            + (f", {json.dumps(out, default=str)}" if isinstance(out, dict) else ""),
            flush=True,
        )
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="sharded serving over four cards, 4M x 768, only")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--k", type=int, default=None)
    args = ap.parse_args(argv)

    # a hung phase must still end the run, non-zero, inside its time limit
    faulthandler.dump_traceback_later(1140, exit=True, file=sys.__stderr__)
    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        faulthandler.cancel_dump_traceback_later()
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    phases = Phases(dev, card())
    print(f"card: {phases.card}", flush=True)

    if args.four:
        if len(jax.devices()) < 4:
            print("chip_smoke --four: needs four GPUs", file=sys.stderr)
            return 2
        n = args.n or 4_000_000
        phases.run("four", phase_four, n, args.dim, args.k or n // 1000, args.seed)
    else:
        from vectorsearch_tpu.quant import codec
        from vectorsearch_tpu.store import Store

        n = args.n or 1_000_000
        k = args.k or n // 1000
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        centers, assign, data, queries = phases.run(
            "corpus", make_corpus, n, args.dim, k, args.seed
        )
        new_docs = centers[:100] * np.float32(2.0) + np.random.default_rng(
            args.seed + 1
        ).standard_normal((100, args.dim), dtype=np.float32)
        wires = phases.run("quantize", codec.quantize, data)
        stored = dequantize_wire(wires)
        store = Store(os.path.join(work, "store.db"))
        cat_id = phases.run("populate", populate_store, store, wires, centers, assign)
        del wires
        eng, _ = phases.run("boot", phase_boot, store, SeededEmbedder(queries, new_docs))
        try:
            phases.run("kernel", lambda: {"max_abs_err": phase_kernel(
                eng._state_for(cat_id, create=False).ivf, queries)})
            phases.run("rebuild", phase_rebuild, eng, cat_id, k)
            report = phases.run(
                "search", phase_search, eng, len(queries), stored, data, queries
            )
            print("search: " + json.dumps(report), flush=True)
            phases.run("mutate", phase_mutate, eng, 100, n)
            phases.run("http", phase_http, eng)
        finally:
            eng.close()
            store.close()
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
