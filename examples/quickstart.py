"""Quickstart: run the engine as a library (no HTTP server).

    python examples/quickstart.py

Uses the deterministic noop embedder so it runs with zero external
services; swap `AI.from_config(cfg)` with a real config for Ollama/OpenAI
embeddings. For the HTTP deployment see main.py and
vectorsearch_tpu.client.Client.
"""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vectorsearch_tpu.config import Config
from vectorsearch_tpu.embed import AI
from vectorsearch_tpu.engine import Engine
from vectorsearch_tpu.store import Store


def main():
    store = Store(":memory:")
    ai = AI.from_config(Config(), use_noop=True, noop_seed=0)
    engine = Engine(store, ai, snapshot_dir=None)

    ids = engine.upload(
        "demo",
        "articles",
        [
            {"name": "intro", "document": {"title": "Hello", "body": "vector search on GPUs"}},
            {"name": "deep", "document": {"title": "IVF", "body": "clustered inverted file index"}},
        ],
    )
    print("uploaded document ids:", ids)

    hits = engine.search("demo", "articles", "vector search", count=2, centroids=-1)
    for h in hits:
        print(f"  #{h.document_id} {h.name!r} sim={h.similarity:.4f} -> {h.document}")

    print("categories:", engine.fetch_category_names("demo"))

    reply = "".join(engine.chat("what is this about?", document_ids=ids[:1]))
    print("chat (noop responds with noise):", reply[:60], "...")

    engine.refresh_centroids(target_cluster_size=1000)
    print("stats:", engine.stats())

    engine.close()
    store.close()


if __name__ == "__main__":
    main()
