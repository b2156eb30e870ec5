"""Vector search framework on JAX/XLA/Pallas for NVIDIA GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
expki/go-vectorsearch: 1-byte affine-quantized embeddings, exact and
IVF-Flat cosine top-k, sharded k-means index builds, streaming inserts, and
an HTTP engine API (upload / search / chat / delete) with pluggable
embedding providers.

Layers (bottom-up; see SURVEY.md §7):
  quant/     wire-compatible u8 codec + int8 device layout
  kernels/   cosine top-k scan kernels (jnp) + grouped IVF bucket scan (Pallas)
  index/     device-resident flat + IVF packed-bucket indexes
  build/     sharded Lloyd's k-means centroid builder
  parallel/  device mesh, shard_map scans, top-k merge
  store/     SQLite persistence + versioned array snapshots
  embed/     AI providers (ollama / openai / deterministic noop)
  engine/    upload/search/chat/delete orchestration, TTL cache
  api/       HTTP server, zstd middleware, OpenAPI surface
"""

__version__ = "0.1.0"
