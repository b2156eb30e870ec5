"""End-to-end engine tests with a deterministic word-hash embedder
(the hermetic seam the reference provides via noop/ai.go, made semantic so
upload->search roundtrips are assertable)."""
import re
import zlib

import numpy as np
import pytest

from vectorsearch_tpu import constants
from vectorsearch_tpu.embed.base import AIProvider
from vectorsearch_tpu.engine import Engine, EngineCache
from vectorsearch_tpu.quant import codec
from vectorsearch_tpu.store import Store

DIM = 64


class WordHashAI(AIProvider):
    """Deterministic 'semantic' embedder: a text's vector is the sum of
    per-word seeded gaussians, so shared words -> high cosine."""

    def __init__(self):
        self.chat_calls = []

    def can_embed(self):
        return True

    def can_chat(self):
        return True

    def can_generate(self):
        return True

    def embed(self, inputs, model=None):
        out = []
        for text in inputs:
            words = re.findall(r"[a-z0-9]+", text.lower())
            words = [
                w for w in words if w not in ("search_query", "search_document")
            ]
            v = np.zeros(DIM, np.float64)
            for w in words:
                rng = np.random.default_rng(zlib.crc32(w.encode()))
                v += rng.normal(size=DIM)
            out.append(codec.quantize(v.astype(np.float32)))
        return out

    def generate(self, prompt, model=None):
        return "gen"

    def generate_stream(self, prompt, model=None):
        yield "gen"

    def chat(self, messages, model=None):
        self.chat_calls.append(messages)
        return "chat"

    def chat_stream(self, messages, model=None):
        self.chat_calls.append(messages)
        yield "chat "
        yield "reply"

    def embed_ctx_num(self):
        return 8192

    def chat_ctx_num(self):
        return 8192

    def embed_model(self):
        return "wordhash"

    def chat_model(self):
        return "wordhash"


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)


@pytest.fixture
def engine(tmp_path):
    store = Store(":memory:")
    ai = WordHashAI()
    eng = Engine(store, ai, snapshot_dir=str(tmp_path / "snaps"),
                 cache=EngineCache(ttl=0.0))  # ttl 0: no cross-test staleness
    yield eng
    eng.close()
    store.close()


FRUIT_DOCS = [
    {"name": "apples", "document": {"text": "apple orchard harvest fruit"}},
    {"name": "bananas", "document": {"text": "banana plantation tropical fruit"}},
    {"name": "cars", "document": {"text": "engine gearbox wheels road"}},
]


def test_upload_and_search_roundtrip(engine):
    ids = engine.upload("alice", "docs", FRUIT_DOCS)
    assert len(ids) == 3
    hits = engine.search("alice", "docs", "banana tropical", count=2)
    assert hits
    assert hits[0].name == "bananas"
    assert hits[0].document == {"text": "banana plantation tropical fruit"}
    assert hits[0].document_id == ids[1]

    hits = engine.search("alice", "docs", "gearbox road", count=1)
    assert hits[0].name == "cars"


def test_search_unknown_owner_or_category(engine):
    assert engine.search("nobody", "docs", "x") == []
    engine.upload("alice", "docs", FRUIT_DOCS[:1])
    assert engine.search("alice", "other", "x") == []


def test_count_clamp_and_offset(engine):
    engine.upload("alice", "docs", FRUIT_DOCS)
    all_hits = engine.search("alice", "docs", "fruit apple banana", count=50)
    assert len(all_hits) <= 20
    first = engine.search("alice", "docs", "fruit apple banana", count=1)
    second = engine.search(
        "alice", "docs", "fruit apple banana", count=1, offset=1
    )
    assert first[0].document_id != second[0].document_id


def test_dedup_by_document(engine):
    # many sections per doc: long text with repeated distinct lines
    long_doc = {
        "name": "long",
        "document": {"text": "\n".join(f"kiwi segment {i}" for i in range(40))},
    }
    monkey_ai = engine.ai

    class TinyCtx(WordHashAI):
        def embed_ctx_num(self):
            return 40  # maxWords = 9 -> many sections

    engine.ai = TinyCtx()
    ids = engine.upload("alice", "docs", [long_doc])
    engine.ai = monkey_ai
    hits = engine.search("alice", "docs", "kiwi segment", count=10)
    assert len([h for h in hits if h.document_id == ids[0]]) == 1


def test_delete_document(engine):
    ids = engine.upload("alice", "docs", FRUIT_DOCS)
    engine.delete_document("alice", "docs", ids[1])
    hits = engine.search("alice", "docs", "banana tropical", count=3)
    assert all(h.document_id != ids[1] for h in hits)


def test_delete_owner_cascades(engine):
    engine.upload("alice", "docs", FRUIT_DOCS)
    engine.delete_owner("alice")
    assert engine.search("alice", "docs", "banana") == []
    assert engine.fetch_category_names("alice") == []


def test_category_names(engine):
    engine.upload("alice", "a", FRUIT_DOCS[:1])
    engine.upload("alice", "b", FRUIT_DOCS[1:2])
    assert engine.fetch_category_names("alice") == ["a", "b"]
    assert engine.fetch_category_names("ghost") == []


def test_chat_prompt_construction(engine):
    ids = engine.upload("alice", "docs", FRUIT_DOCS[:1])
    out = "".join(
        engine.chat(
            "what fruit?",
            prefix="Please answer",
            history=["hi", "hello!"],
            document_ids=[ids[0]],
        )
    )
    assert out == "chat reply"
    messages = engine.ai.chat_calls[-1]
    assert [m["role"] for m in messages] == ["user", "assistant", "user"]
    final = messages[-1]["content"]
    assert "I have 1 text document" in final
    assert '"""' in final and "apple orchard" in final
    assert "My question is: Please answer. what fruit?" in final


def test_refresh_centroids_rebuilds(engine):
    docs = [
        {"name": f"d{i}", "document": {"text": f"word{i % 5} common text {i}"}}
        for i in range(60)
    ]
    engine.upload("alice", "docs", docs)
    res = engine.refresh_centroids(target_cluster_size=20, chunk=256)
    assert any(res.values())
    cat = engine.store.get_category(engine.store.get_owner("alice").id, "docs")
    state = engine._state_for(cat.id, create=False)
    assert state.ivf.k_clusters >= 2
    # DB centroid rows swapped to match
    assert len(engine.store.centroids(cat.id)) == state.ivf.k_clusters
    # search still works after rebuild
    hits = engine.search("alice", "docs", "word3 common", count=3, centroids=-1)
    assert hits


def test_snapshot_boot(tmp_path):
    store = Store(str(tmp_path / "db.sqlite"))
    snaps = str(tmp_path / "snaps")
    eng = Engine(store, WordHashAI(), snapshot_dir=snaps)
    eng.upload("alice", "docs", FRUIT_DOCS)
    eng.refresh_centroids(target_cluster_size=20, chunk=256)
    eng.close()

    # reboot from the same SQL + snapshots
    eng2 = Engine(store, WordHashAI(), snapshot_dir=snaps)
    hits = eng2.search("alice", "docs", "banana tropical", count=1)
    assert hits and hits[0].name == "bananas"
    eng2.close()
    store.close()


def test_boot_from_sql_without_snapshot(tmp_path):
    store = Store(str(tmp_path / "db.sqlite"))
    eng = Engine(store, WordHashAI(), snapshot_dir=None)
    eng.upload("alice", "docs", FRUIT_DOCS)
    eng.close()
    eng2 = Engine(store, WordHashAI(), snapshot_dir=None)
    hits = eng2.search("alice", "docs", "gearbox road", count=1)
    assert hits and hits[0].name == "cars"
    eng2.close()
    store.close()


def test_search_nprobe_parameter(engine):
    docs = [
        {"name": f"d{i}", "document": {"text": f"cluster{i % 4} text {i}"}}
        for i in range(40)
    ]
    engine.upload("alice", "docs", docs)
    engine.refresh_centroids(target_cluster_size=10, chunk=256)
    # centroids=0 -> nprobe 1; -1 -> all; both must return results
    h1 = engine.search("alice", "docs", "cluster2 text", count=5, centroids=0)
    hall = engine.search("alice", "docs", "cluster2 text", count=5, centroids=-1)
    assert h1 and hall
    # full probe can only find an equal-or-better top hit
    assert hall[0].similarity >= h1[0].similarity - 1e-5


def test_sharded_serving_lifecycle(tmp_path):
    """mesh set: rebuild creates a sharded read replica; mutations
    invalidate it; searches stay correct throughout."""
    from vectorsearch_tpu.parallel import default_mesh

    store = Store(":memory:")
    eng = Engine(
        store, WordHashAI(), cache=EngineCache(ttl=0.0), mesh=default_mesh(8)
    )
    docs = [
        {"name": f"d{i}", "document": {"text": f"topic{i % 4} words {i}"}}
        for i in range(40)
    ]
    eng.upload("alice", "docs", docs)
    cat = store.get_category(store.get_owner("alice").id, "docs")
    state = eng._state_for(cat.id, create=False)
    assert state.sharded is None  # no rebuild yet

    eng.refresh_centroids(target_cluster_size=10, chunk=64)
    assert state.sharded is not None
    hits = eng.search("alice", "docs", "topic2 words", count=3, centroids=-1)
    assert hits and "topic2" in hits[0].document["text"]

    # a mutation invalidates the replica; search falls back and still works
    eng.upload("alice", "docs", [{"name": "new", "document": {"text": "fresh topic9"}}])
    assert state.sharded is None
    hits = eng.search("alice", "docs", "fresh topic9", count=1, centroids=-1)
    assert hits and hits[0].name == "new"
    eng.close()
    store.close()


def test_stale_snapshot_rebuilds_from_sql(tmp_path):
    """A snapshot that no longer matches the DB row count is detected as
    stale at boot and the index is rebuilt from SQL."""
    db = str(tmp_path / "db.sqlite")
    snaps = str(tmp_path / "snaps")
    store = Store(db)
    eng = Engine(store, WordHashAI(), snapshot_dir=snaps)
    eng.upload("alice", "docs", FRUIT_DOCS[:2])
    eng.close()  # snapshot written with n=2

    # second writer adds a doc WITHOUT snapshotting (simulates crash or
    # another instance): snapshot is now stale
    eng_b = Engine(store, WordHashAI(), snapshot_dir=None)
    eng_b.upload("alice", "docs", FRUIT_DOCS[2:])
    eng_b.close()

    eng2 = Engine(store, WordHashAI(), snapshot_dir=snaps)
    hits = eng2.search("alice", "docs", "gearbox road", count=1, centroids=-1)
    assert hits and hits[0].name == "cars"  # the doc missing from the snapshot
    eng2.close()
    store.close()


def test_warmup_noop_and_compile(engine):
    engine.warmup()  # empty: no-op
    engine.upload("alice", "docs", FRUIT_DOCS)
    engine.warmup()  # compiles the serving shapes without error
    hits = engine.search("alice", "docs", "banana tropical", count=1)
    assert hits


def test_warmup_malformed_env_degrades(engine, monkeypatch):
    """ADVICE r3: a malformed VSTPU_WARM_NPROBES must degrade to the
    default with a warning, not raise out of boot."""
    engine.upload("alice", "docs", FRUIT_DOCS[:1])
    monkeypatch.setenv("VSTPU_WARM_NPROBES", "1;8")
    engine.warmup()  # must not raise


def test_warmup_config_nprobes(tmp_path, monkeypatch):
    """VERDICT r3 #7: the config file's warm_nprobes drives warmup; env
    overrides config."""
    from vectorsearch_tpu.config import Config

    cfg = Config.parse(
        '{"server": {"warm_nprobes": [1, 8]}}'
    )
    assert cfg.server.warm_nprobes == (1, 8)
    # round-trips through to_dict
    assert Config.parse(
        __import__("json").dumps(cfg.to_dict())
    ).server.warm_nprobes == (1, 8)

    store = Store(":memory:")
    eng = Engine(store, WordHashAI(), warm_nprobes=cfg.server.warm_nprobes)
    eng.upload("alice", "docs", FRUIT_DOCS)
    seen = []
    orig = type(eng._states[1].ivf).search

    def spy(self, q, k, nprobe=1, refine=0):
        seen.append(nprobe)
        return orig(self, q, k, nprobe=nprobe, refine=refine)

    monkeypatch.setattr(type(eng._states[1].ivf), "search", spy)
    eng.warmup()
    # config asked for both widths (clamped inside search as needed)
    assert {1, 8} <= set(seen)
    # env override wins over config
    seen.clear()
    monkeypatch.setenv("VSTPU_WARM_NPROBES", "1")
    eng.warmup()
    assert set(seen) == {1}
    eng.close()
    store.close()


def test_upload_right_after_missed_search(tmp_path):
    """A search for a missing owner must not poison the cache with None:
    an upload inside the TTL window then creates the owner normally."""
    store = Store(":memory:")
    eng = Engine(store, WordHashAI(), cache=EngineCache(ttl=60.0))
    assert eng.search("alice", "docs", "x") == []  # caches nothing
    ids = eng.upload("alice", "docs", FRUIT_DOCS[:1])
    assert ids
    hits = eng.search("alice", "docs", "apple orchard", count=1)
    assert hits and hits[0].document_id == ids[0]
    eng.close()
    store.close()


def test_multi_instance_sync(tmp_path):
    """Two engine instances over one shared store: writes from A become
    visible on B after sync_with_store (the reference reads SQL per search;
    HBM residency trades that for explicit sync)."""
    db = str(tmp_path / "shared.sqlite")
    store_a = Store(db)
    store_b = Store(db)
    a = Engine(store_a, WordHashAI(), cache=EngineCache(ttl=0.0))
    b = Engine(store_b, WordHashAI(), cache=EngineCache(ttl=0.0))

    ids = a.upload("alice", "docs", FRUIT_DOCS)
    assert b.search("alice", "docs", "banana tropical") == []  # stale B
    assert b.sync_with_store()  # detects the new category+rows
    hits = b.search("alice", "docs", "banana tropical", count=1, centroids=-1)
    assert hits and hits[0].document_id == ids[1]

    # incremental change: A uploads more; B syncs the diff
    a.upload("alice", "docs", [{"name": "kiwi", "document": {"text": "kiwi fruit"}}])
    assert b.sync_with_store()
    hits = b.search("alice", "docs", "kiwi fruit", count=1, centroids=-1)
    assert hits and hits[0].name == "kiwi"

    # no-op when nothing changed
    assert b.sync_with_store() == []

    # delete+upload pair on A leaves COUNT(*) AND the centroid-id list
    # unchanged — only MAX(embeddings.id) moves; B must still detect it
    # (ADVICE r1: count-only signal left remote docs unsearchable)
    a.delete_document("alice", "docs", ids[0])
    a.upload("alice", "docs", [{"name": "mango", "document": {"text": "mango tree"}}])
    assert b.sync_with_store()
    hits = b.search("alice", "docs", "mango tree", count=1, centroids=-1)
    assert hits and hits[0].name == "mango"

    # remote delete propagates
    a.delete_owner("alice")
    assert b.sync_with_store()
    assert b.search("alice", "docs", "kiwi fruit") == []
    for e, s in ((a, store_a), (b, store_b)):
        e.close(); s.close()


def test_snapshot_stale_on_centroid_change(tmp_path):
    """A rebuild that changes the centroid set but not the row count must
    invalidate the snapshot (centroid ids recorded in snapshot meta)."""
    db = str(tmp_path / "db.sqlite")
    snaps = str(tmp_path / "snaps")
    store = Store(db)
    eng = Engine(store, WordHashAI(), snapshot_dir=snaps)
    docs = [
        {"name": f"d{i}", "document": {"text": f"w{i % 4} common {i}"}}
        for i in range(40)
    ]
    eng.upload("alice", "docs", docs)
    eng.close()  # snapshot A: 1 bootstrap centroid, 40 rows

    # rebuild through an engine WITHOUT snapshots: DB centroids change,
    # row count stays 40 -> snapshot A is silently stale
    eng_b = Engine(store, WordHashAI(), snapshot_dir=None)
    eng_b.refresh_centroids(target_cluster_size=10, chunk=64)
    eng_b.close()

    eng2 = Engine(store, WordHashAI(), snapshot_dir=snaps)
    cat = store.get_category(store.get_owner("alice").id, "docs")
    st = eng2._state_for(cat.id, create=False)
    # restored state must match the DB's rebuilt centroid set, not snapshot A
    assert st.ivf.k_clusters == len(store.centroids(cat.id))
    assert st.ivf.k_clusters >= 2
    hits = eng2.search("alice", "docs", "w2 common", count=3, centroids=-1)
    assert hits
    eng2.close()
    store.close()


def test_snapshot_stale_on_equal_count_churn(tmp_path):
    """Equal-count churn while the process is down (delete one doc, upload
    another) must invalidate the snapshot via the max-id meta (ADVICE r1:
    the count-only heuristic restored a stale index)."""
    db = str(tmp_path / "db.sqlite")
    snaps = str(tmp_path / "snaps")
    store = Store(db)
    eng = Engine(store, WordHashAI(), snapshot_dir=snaps)
    ids = eng.upload("alice", "docs", FRUIT_DOCS)
    eng.close()  # snapshot: len(FRUIT_DOCS) rows

    # churn through a snapshot-less engine: same count, different rows
    eng_b = Engine(store, WordHashAI(), snapshot_dir=None)
    eng_b.delete_document("alice", "docs", ids[0])
    eng_b.upload("alice", "docs", [{"name": "mango", "document": {"text": "mango tree"}}])
    eng_b.close()

    eng2 = Engine(store, WordHashAI(), snapshot_dir=snaps)
    hits = eng2.search("alice", "docs", "mango tree", count=1, centroids=-1)
    assert hits and hits[0].name == "mango"
    eng2.close()
    store.close()


def test_snapshot_corrupt_file_falls_back(tmp_path):
    """A corrupt npz (torn write, bad zip) must fall back to the SQL boot
    path instead of crashing (ADVICE r1: BadZipFile escaped load())."""
    import glob

    db = str(tmp_path / "db.sqlite")
    snaps = str(tmp_path / "snaps")
    store = Store(db)
    eng = Engine(store, WordHashAI(), snapshot_dir=snaps)
    ids = eng.upload("alice", "docs", FRUIT_DOCS)
    eng.close()
    for path in glob.glob(str(tmp_path / "snaps" / "*" / "snap-*.npz")):
        with open(path, "wb") as f:
            f.write(b"not a zip at all")
    eng2 = Engine(store, WordHashAI(), snapshot_dir=snaps)
    hits = eng2.search("alice", "docs", "banana tropical", count=1, centroids=-1)
    assert hits and hits[0].document_id == ids[1]
    eng2.close()
    store.close()


# ---------------------------------------------------------- deep pagination


class TinyCtxAI(WordHashAI):
    """ctx 9 -> max_words 2: every ~2-word line becomes its own section,
    so documents fan out to many embeddings and dedup shrinks the
    candidate set (the deep-pagination trigger)."""

    def embed_ctx_num(self):
        return 9


def test_deep_pagination_returns_exact_window(tmp_path):
    """Reference semantics: any offset window is exact
    (server/search.go:256-270 scans everything). With 8 identical
    sections per document the initial k class holds only k/8 unique docs,
    so deep windows force the escalation re-dispatch path."""
    store = Store(":memory:")
    eng = Engine(store, TinyCtxAI(), cache=EngineCache(ttl=0.0))
    n_docs = 48
    docs = [
        {
            "name": f"d{i:02d}",
            # 8 identical 2-word lines -> 8 identical sections/embeddings
            "document": {"text": "\n".join([f"word{i:02d} tok{i:02d}"] * 8)},
        }
        for i in range(n_docs)
    ]
    eng.upload("o", "deep", docs)
    st = eng._state_for(store.get_category(store.get_owner("o").id, "deep").id,
                        create=False)
    assert st.ivf.n_live >= 8 * n_docs  # sections really fanned out

    # target one doc's words so ordering is deterministic-ish; scan all
    # clusters so the pool is the whole corpus
    pages = []
    for offset in range(0, n_docs, 12):
        hits = eng.search("o", "deep", "word07 tok07", count=12,
                          offset=offset, centroids=-1)
        pages.append(hits)
    # every full window before the end must be complete (48 docs total)
    assert [len(p) for p in pages] == [12, 12, 12, 12]
    names = [h.name for p in pages for h in p]
    assert len(set(names)) == n_docs  # disjoint, exhaustive pages
    # scores are non-increasing across page boundaries
    sims = [h.similarity for p in pages for h in p]
    assert all(s1 >= s2 - 1e-6 for s1, s2 in zip(sims, sims[1:]))
    eng.close()
    store.close()


# ------------------------------------------------------------ client cancel


def test_search_cancel_aborts_before_dispatch(engine):
    import threading

    from vectorsearch_tpu.engine.engine import RequestCanceled

    engine.upload("alice", "docs", FRUIT_DOCS)
    d0 = engine._batcher.stats()["dispatches"]

    cancel = threading.Event()

    class DisconnectDuringEmbed(WordHashAI):
        def embed(self, inputs, model=None):
            out = super().embed(inputs, model)
            cancel.set()  # client went away while the provider worked
            return out

    engine.ai = DisconnectDuringEmbed()
    try:
        with pytest.raises(RequestCanceled):
            engine.search("alice", "docs", "banana", count=2, cancel=cancel)
    finally:
        engine.ai = WordHashAI()
    # the engine aborted BEFORE the device dispatch
    assert engine._batcher.stats()["dispatches"] == d0
    # an uncancelled search still works
    assert engine.search("alice", "docs", "banana", count=1)


def test_upload_cancel_aborts_before_persist(engine):
    import threading

    from vectorsearch_tpu.engine.engine import RequestCanceled

    cancel = threading.Event()
    cancel.set()
    with pytest.raises(RequestCanceled):
        engine.upload("alice", "docs", FRUIT_DOCS, cancel=cancel)
    assert engine.fetch_category_names("alice") == []  # nothing persisted


# ------------------------------------------------------- boot paths (10M prep)


def test_snapshot_boot_skips_sql_row_scan(tmp_path):
    """A snapshot hit must not stream the embeddings table (at 10M that
    scan costs minutes): ids, assignments AND the emb->doc map all ride
    in the snapshot."""
    snap_dir = str(tmp_path / "snaps")
    store = Store(str(tmp_path / "s.db"))
    eng = Engine(store, WordHashAI(), snapshot_dir=snap_dir,
                 cache=EngineCache(ttl=0.0))
    ids = eng.upload("o", "c", FRUIT_DOCS)
    eng.close()  # saves the snapshot

    class NoRowScanStore:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            if name in ("iter_embeddings", "embeddings_page",
                        "embedding_doc_pairs", "embedding_doc_map"):
                raise AssertionError(f"boot touched {name} despite snapshot")
            return getattr(self._inner, name)

    eng2 = Engine(NoRowScanStore(store), WordHashAI(),
                  snapshot_dir=snap_dir, cache=EngineCache(ttl=0.0))
    hits = eng2.search("o", "c", "banana tropical", count=2)
    assert hits and hits[0].name == "bananas"
    assert hits[0].document_id == ids[1]
    eng2.close()
    store.close()


def test_sql_boot_uses_stored_assignments(tmp_path):
    """The SQL fallback boot must take assignments from the embeddings
    table's centroid_id column, not a device re-assignment pass."""
    from vectorsearch_tpu.index import ivf as ivf_mod

    store = Store(str(tmp_path / "s.db"))
    eng = Engine(store, WordHashAI(), cache=EngineCache(ttl=0.0))
    eng.upload("o", "c", FRUIT_DOCS)
    eng.close()

    real = ivf_mod.assign_clusters

    def forbidden(*a, **kw):
        raise AssertionError("SQL boot ran a device assignment pass")

    ivf_mod.assign_clusters = forbidden
    try:
        eng2 = Engine(store, WordHashAI(), cache=EngineCache(ttl=0.0))
        hits = eng2.search("o", "c", "banana tropical", count=2)
        assert hits and hits[0].name == "bananas"
        eng2.close()
    finally:
        ivf_mod.assign_clusters = real
    store.close()


def test_boot_saves_snapshot_from_host_and_clean_close_skips_export(tmp_path):
    """The SQL-fallback boot writes the snapshot from the host arrays it
    already holds; an unmutated close() must NOT export the packed store
    from the device (a 15+ GB read-back at 10M scale)."""
    from vectorsearch_tpu.index import IVFIndex

    snap_dir = str(tmp_path / "snaps")
    store = Store(str(tmp_path / "s.db"))
    eng = Engine(store, WordHashAI(), snapshot_dir=snap_dir,
                 cache=EngineCache(ttl=0.0))
    eng.upload("o", "c", FRUIT_DOCS)
    eng.close()  # dirty (upload) -> saves

    # boot #2 hits the close-snapshot; unmutated -> close must not export
    real_export = IVFIndex.export_live_assigned
    calls = []

    def counting(self, *a, **kw):
        calls.append(1)
        return real_export(self, *a, **kw)

    IVFIndex.export_live_assigned = counting
    try:
        eng2 = Engine(store, WordHashAI(), snapshot_dir=snap_dir,
                      cache=EngineCache(ttl=0.0))
        assert eng2.search("o", "c", "banana tropical", count=1)
        eng2.close()
        assert calls == []  # clean close: no device export
    finally:
        IVFIndex.export_live_assigned = real_export

    # boot #3 from SQL (snapshots wiped): the boot itself writes one,
    # and a clean close still skips the export
    import shutil

    shutil.rmtree(snap_dir)
    IVFIndex.export_live_assigned = counting
    try:
        eng3 = Engine(store, WordHashAI(), snapshot_dir=snap_dir,
                      cache=EngineCache(ttl=0.0))
        from vectorsearch_tpu.store import snapshots as snaps_mod

        cat = store.get_category(store.get_owner("o").id, "c")
        assert snaps_mod.latest_version(snap_dir, f"cat-{cat.id}") > 0
        eng3.close()
        assert calls == []
    finally:
        IVFIndex.export_live_assigned = real_export
    store.close()


# ---------------------------------------------------------------- batch search


def test_search_many_matches_single(engine):
    ids = engine.upload("alice", "docs", FRUIT_DOCS)
    assert len(ids) == 3
    queries = ["banana tropical", "gearbox road", "apple orchard"]
    pages = engine.search_many("alice", "docs", queries, count=3)
    assert len(pages) == 3
    for q, page in zip(queries, pages):
        single = engine.search("alice", "docs", q, count=3)
        assert [h.document_id for h in page] == [h.document_id for h in single]
        assert [h.name for h in page] == [h.name for h in single]
        for a, b in zip(page, single):
            assert a.similarity == pytest.approx(b.similarity, abs=1e-6)
            assert a.document == b.document


def test_search_many_ids_only_skips_documents(engine):
    engine.upload("alice", "docs", FRUIT_DOCS)
    store = engine.store
    calls = []
    real_fetch = store.fetch_documents
    store.fetch_documents = lambda ids: calls.append(ids) or real_fetch(ids)
    try:
        pages = engine.search_many(
            "alice", "docs", ["banana tropical"], count=2,
            include_documents=False,
        )
    finally:
        store.fetch_documents = real_fetch
    assert calls == []  # SQL fetch skipped entirely
    assert pages[0]
    assert pages[0][0].document is None
    assert pages[0][0].name == ""
    single = engine.search("alice", "docs", "banana tropical", count=2)
    assert [h.document_id for h in pages[0]] == [h.document_id for h in single]


def test_search_many_empty_and_unknown(engine):
    assert engine.search_many("alice", "docs", []) == []
    assert engine.search_many("nobody", "docs", ["x", "y"]) == [[], []]
    engine.upload("alice", "docs", FRUIT_DOCS[:1])
    assert engine.search_many("alice", "other", ["x"]) == [[]]


def test_search_many_deep_window_falls_back_to_exact(tmp_path):
    """A row whose k-class candidates dedup below the requested window
    must fall back to the escalating window helper (same exact-window
    guarantee as Engine.search deep pagination) WITHOUT re-embedding
    the query — the batched embed is reused."""
    store = Store(":memory:")
    eng = Engine(store, TinyCtxAI(), cache=EngineCache(ttl=0.0))
    docs = [
        {
            "name": f"d{i}",
            "document": {
                "text": "\n".join(f"melon slice {i} part {j}" for j in range(12))
            },
        }
        for i in range(8)
    ]
    eng.upload("o", "c", docs)
    eng.ai = WordHashAI()
    # want=8 -> k class 32; each doc contributes many sections so 32
    # candidates dedup below 8 docs and the batched row must escalate
    window_calls = []
    real_window = eng._window_hits

    def counting_window(*a, **kw):
        window_calls.append(a)
        return real_window(*a, **kw)

    embed_calls = []
    real_embed = eng.ai.embed

    def counting_embed(texts, model):
        embed_calls.append(list(texts))
        return real_embed(texts, model)

    eng._window_hits = counting_window
    eng.ai.embed = counting_embed
    pages = eng.search_many("o", "c", ["melon slice"], count=4, offset=4)
    eng._window_hits = real_window
    eng.ai.embed = real_embed
    assert window_calls  # the short row really took the fallback path
    assert len(embed_calls) == 1  # fallback reused the batched embed
    single = eng.search("o", "c", "melon slice", count=4, offset=4)
    assert [h.document_id for h in pages[0]] == [h.document_id for h in single]
    assert len(pages[0]) == 4
    eng.close()
    store.close()
