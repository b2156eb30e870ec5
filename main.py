"""Process entry point (reference: main.go:31-224).

Boot order mirrors the reference: config load (sample generated on first
run), logger, AI providers, startup micro-benchmark (preftest), store,
engine (HBM index boot), background centroid refresh, HTTP + HTTPS/h2
listeners, graceful shutdown on SIGINT/SIGTERM.

Usage: python main.py [config.json]
"""
from __future__ import annotations

import asyncio
import os
import signal
import sys
import threading

from aiohttp import web

from vectorsearch_tpu.utils import enable_compile_cache

# Persistent XLA compile cache. Config only — safe before
# jax.distributed.initialize, which must precede any device use.
enable_compile_cache()

from vectorsearch_tpu import config as config_mod
from vectorsearch_tpu.api import TLSManager, build_app
from vectorsearch_tpu.embed import AI
from vectorsearch_tpu.engine import Engine
from vectorsearch_tpu.logger import configure, sugar
from vectorsearch_tpu.store import Store


def preftest():
    """Startup micro-benchmark (reference: main.go:247-286): times the
    matrix cosine kernel and quantize/dequantize round trips, logging wall
    times as a smoke/perf check."""
    import time

    import numpy as np

    from vectorsearch_tpu.kernels import cosine
    from vectorsearch_tpu.quant import codec, layout

    rng = np.random.default_rng(0)
    data = rng.normal(size=(500, 512)).astype(np.float32)
    packed = layout.pack_float(data)
    queries = rng.normal(size=(500, 512)).astype(np.float32)

    import jax.numpy as jnp

    q = jnp.asarray(queries)
    t0 = time.perf_counter()
    for _ in range(10):
        cosine.scores_packed(q, packed).block_until_ready()
    sugar().info(
        "preftest matrix cosine 500x500@512 x10: %.1fms",
        (time.perf_counter() - t0) * 1e3,
    )

    big = rng.normal(size=(1000, 512)).astype(np.float32)
    t0 = time.perf_counter()
    for _ in range(50):
        wire = codec.quantize(big)
    sugar().info("preftest quantize 1000x512 x50: %.1fms", (time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(50):
        codec.dequantize(wire)
    sugar().info("preftest dequantize 1000x512 x50: %.1fms", (time.perf_counter() - t0) * 1e3)


def build_store(cfg: config_mod.Config):
    """Store selection (reference: database/database.go:25-103).

    Priority: postgres DSNs (primary + strict-round-robin read replicas,
    over the pure-Python wire client store/pgwire.py) > database.remote
    (mount another instance's store server) > local SQLite."""
    if cfg.database.postgres:
        from vectorsearch_tpu.store.pg import PgStore

        store = PgStore(
            list(cfg.database.postgres), list(cfg.database.postgres_readonly)
        )
        sugar().info(
            "using postgres primary (+%d write failover DSNs, "
            "%d read replicas)",
            len(cfg.database.postgres) - 1,
            len(cfg.database.postgres_readonly),
        )
        return store
    if cfg.database.remote:
        # mount another instance's store server (cross-host shared store,
        # the Postgres-role analogue — store/remote.py)
        from vectorsearch_tpu.store.remote import RemoteStore

        store = RemoteStore(
            cfg.database.remote, token=cfg.database.store_token
        )
        sugar().info("using remote store %s", cfg.database.remote)
        return store
    return Store(cfg.database.sqlite)


def _addr(spec: str) -> tuple[str | None, int]:
    """Parse ':7500', 'host:7500', or '[::1]:7500' address specs."""
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"invalid listen address {spec!r}: expected [host]:port"
        )
    host = host.strip("[]")  # bracketed IPv6
    return (host or None), int(port)


async def serve(cfg: config_mod.Config, engine: Engine):
    app = build_app(engine)
    # auto_decompress=False: aiohttp's parser has no zstd codec; the app's
    # middleware decompresses request bodies itself (reference middleware:
    # main.go:129-166)
    # handler_cancellation: client disconnects cancel the handler task,
    # which trips the engine's cancel token (reference aborts on ctx.Err()
    # at every stage, server/search.go:86-91); off by default in aiohttp>=3.9
    runner = web.AppRunner(
        app, auto_decompress=False, handler_cancellation=True
    )
    await runner.setup()

    http_host, http_port = _addr(cfg.server.http_address)
    sites = [web.TCPSite(runner, http_host, http_port)]
    for site in sites:
        await site.start()

    tls = None
    tls_server = None
    if cfg.server.https_address:
        try:
            from vectorsearch_tpu.api.h2 import serve_tls_mux

            tls = TLSManager(cfg.tls)
            tls.start()
            https_host, https_port = _addr(cfg.server.https_address)
            # h2 + http/1.1 over one TLS port (reference main.go:104-115);
            # both ALPN branches serve the same app via the plaintext
            # listener (api/h2.py)
            tls_server = await serve_tls_mux(
                https_host, https_port, tls.context(),
                (http_host or "127.0.0.1", http_port),
            )
        except Exception as e:
            sugar().error("HTTPS disabled: %s", e)
            tls.close()  # stop the hourly reload thread start() spawned
            tls = None
    sugar().info(
        "listening on http %s%s",
        cfg.server.http_address,
        f" / https {cfg.server.https_address} (h2, http/1.1)" if tls else "",
    )

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    sugar().info("shutting down")
    if tls_server is not None:
        tls_server.close()
        await tls_server.wait_closed()
        await tls_server._vstpu_session.close()
    await runner.cleanup()
    if tls:
        tls.close()


def main(argv: list[str]) -> int:
    config_path = argv[1] if len(argv) > 1 else "config.json"
    if not os.path.exists(config_path):
        config_mod.create_sample(config_path)
        print(
            f"sample configuration created at {config_path}; edit it and rerun",
            file=sys.stderr,
        )
        return 1
    cfg = config_mod.load(config_path)
    configure(cfg.log_level)

    if cfg.mesh.coordinator:
        # multi-process: join the distributed runtime BEFORE ANY device
        # use — jax.distributed.initialize raises once an XLA backend
        # exists, so this must precede preftest (parallel/distributed.py)
        from vectorsearch_tpu.parallel.distributed import maybe_initialize

        maybe_initialize(
            cfg.mesh.coordinator, cfg.mesh.num_processes, cfg.mesh.process_id,
            local_device_ids=cfg.mesh.local_devices(),
        )
        sugar().info(
            "distributed runtime: process %d/%d via %s",
            cfg.mesh.process_id, cfg.mesh.num_processes, cfg.mesh.coordinator,
        )

    ai = AI.from_config(cfg, use_noop=os.environ.get("VSTPU_NOOP_AI") == "1")

    mesh = None
    if cfg.mesh.shard_serving:
        from vectorsearch_tpu.parallel.distributed import global_mesh

        mesh = global_mesh(cfg.mesh.devices or None)
        sugar().info("sharded serving over %d devices", mesh.devices.size)

    store_server = None
    store = build_store(cfg)
    if cfg.database.serve_store:
        if not isinstance(store, Store):
            # serving while mounted on a remote/postgres store would export
            # a fresh empty sqlite file, silently diverging from the store
            # this instance actually uses — a config error, not a feature
            # (postgres deployments share state through postgres itself)
            sugar().error(
                "database.serve_store ignored: this instance's store is "
                "%s, not a local sqlite file; other hosts should share "
                "that store directly", type(store).__name__,
            )
        else:
            from vectorsearch_tpu.store.remote import StoreServer

            host, port = _addr(cfg.database.serve_store)
            store_server = StoreServer(
                store, host or "0.0.0.0", port,
                token=cfg.database.store_token,
            ).start()
            if not cfg.database.store_token:
                sugar().warning(
                    "store server has NO auth token (database.store_token): "
                    "any peer that can reach the port can call every store "
                    "method including deletes"
                )
            sugar().info("store server listening on %s", store_server.address)
    preftest()
    engine = Engine(
        store, ai, snapshot_dir=cfg.database.snapshots, mesh=mesh,
        warm_nprobes=cfg.server.warm_nprobes,
    )

    # one-shot background index refresh at startup (reference: main.go:92),
    # preceded by jit warmup of the serving shapes
    def _startup():
        engine.warmup()
        engine.refresh_centroids()

    threading.Thread(target=_startup, daemon=True).start()

    if cfg.database.sync_interval > 0:
        # multi-instance deployments: poll the shared store for divergence
        def _sync_loop():
            import time as _time

            while True:
                _time.sleep(cfg.database.sync_interval)
                try:
                    engine.sync_with_store()
                except Exception as e:
                    sugar().warning("store sync failed: %s", e)

        threading.Thread(target=_sync_loop, daemon=True).start()

    try:
        asyncio.run(serve(cfg, engine))
    finally:
        engine.close()
        store.close()
        if store_server is not None:
            store_server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
