"""Distributed-runtime seam (parallel/distributed.py): the full
initialize -> global mesh -> sharded search path, run in a SUBPROCESS so
jax.distributed doesn't contaminate this test process' runtime. Only one
host exists in this environment, so num_processes=1 exercises the real
coordinator handshake + global device list; multi-DEVICE semantics are
covered by the 8-device virtual mesh in test_parallel.py and the
driver's dryrun_multichip."""
import subprocess
import sys

SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import os, sys
sys.path.insert(0, %(repo)r)
import numpy as np
from vectorsearch_tpu.parallel.distributed import (
    global_mesh, maybe_initialize, put_sharded,
)

# real coordinator handshake, single process
assert maybe_initialize("127.0.0.1:%(port)d", num_processes=1, process_id=0)
assert maybe_initialize("127.0.0.1:%(port)d") is True  # idempotent
assert jax.process_count() == 1

mesh = global_mesh()
assert mesh.devices.size == len(jax.devices())

# sharded index over the global mesh end-to-end
from vectorsearch_tpu.parallel import ShardedFlat
from vectorsearch_tpu.quant import layout

rng = np.random.default_rng(0)
v = rng.normal(size=(64, 32)).astype(np.float32)
packed = layout.pack_float(v)
idx = ShardedFlat.build(mesh, packed, np.arange(1, 65, dtype=np.int64))
s, ids = idx.search(v[:3], k=5, chunk=64)
assert (ids[:, 0] == [1, 2, 3]).all(), ids[:, 0]

# put_sharded places through the addressable path on one host
from vectorsearch_tpu.parallel.mesh import row_sharding
arr = put_sharded(np.ones((mesh.devices.size * 2, 4), np.float32), row_sharding(mesh))
assert arr.shape == (mesh.devices.size * 2, 4)
print("DISTRIBUTED_OK")
"""


def test_initialize_and_sharded_search(unused_tcp_port_factory=None):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    import os

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT % {"repo": os.getcwd(), "port": port}],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
        cwd=os.getcwd(),
    )
    assert "DISTRIBUTED_OK" in out.stdout, (out.stdout, out.stderr[-2000:])


def test_two_process_global_mesh(tmp_path):
    """REAL multi-process jax.distributed: two coordinated processes, a
    4-device global mesh (2 local each), cross-process psum, multi-host
    put_sharded (the not-fully-addressable make_array path), and a
    ShardedFlat search over the cross-process mesh — the contract
    SURVEY.md §2.8's last row names, exercised with process_count > 1."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    child = tmp_path / "child.py"
    child.write_text(
        r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[2])
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from vectorsearch_tpu.parallel.distributed import (
    global_mesh, maybe_initialize, put_sharded,
)
from vectorsearch_tpu.parallel.mesh import DATA_AXIS, row_sharding

pid = int(sys.argv[1])
assert maybe_initialize(sys.argv[3], num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.local_devices()) == 2
assert len(jax.devices()) == 4

mesh = global_mesh()
assert mesh.devices.size == 4

# multi-host placement: every process passes the same HOST-GLOBAL array
sh = row_sharding(mesh)
assert not sh.is_fully_addressable
data = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
arr = put_sharded(data, sh)
assert arr.shape == (8, 4)

# cross-process collectives: psum + all_gather reassembly must see every
# process's rows
summed, gathered = jax.jit(jax.shard_map(
    lambda x: (
        jax.lax.psum(jnp.sum(x), DATA_AXIS),
        jax.lax.all_gather(x, DATA_AXIS, tiled=True),
    ),
    mesh=mesh, in_specs=P(DATA_AXIS), out_specs=(P(), P()),
    check_vma=False,
))(arr)
assert float(summed.addressable_shards[0].data[()]) == data.sum()
assert np.array_equal(
    np.asarray(gathered.addressable_shards[0].data), data
)

# a sharded index over the cross-process mesh, searched in lockstep
from vectorsearch_tpu.parallel import ShardedFlat
from vectorsearch_tpu.quant import layout

rng = np.random.default_rng(0)
v = rng.normal(size=(64, 32)).astype(np.float32)
packed = layout.pack_float(v)
idx = ShardedFlat.build(mesh, packed, np.arange(1, 65, dtype=np.int64))
s, ids = idx.search(v[:3], k=5, chunk=64)
assert (np.asarray(ids)[:, 0] == [1, 2, 3]).all(), ids
print("MULTIPROCESS_OK", pid, flush=True)
"""
    )
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)
    repo = os.getcwd()
    coord = f"127.0.0.1:{port}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(child), str(pid), repo, coord],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=repo,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((out, err))
    for pid, (out, err) in enumerate(outs):
        assert f"MULTIPROCESS_OK {pid}" in out, (pid, out, err[-3000:])


def test_main_import_leaves_distributed_init_possible(tmp_path):
    """Importing main must not touch a device: jax.distributed.initialize
    refuses to run once any XLA backend is initialized, so a
    mesh.coordinator deployment must still be able to init AFTER
    import."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "probe.py"
    script.write_text(
        r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
import main  # noqa: F401  (must not touch a device)
from vectorsearch_tpu.parallel.distributed import maybe_initialize
assert maybe_initialize(sys.argv[2], num_processes=1, process_id=0)
assert jax.process_count() == 1
print("IMPORT_ORDER_OK")
"""
    )
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, str(script), os.getcwd(), f"127.0.0.1:{port}"],
        capture_output=True, text=True, timeout=120, env=env, cwd=os.getcwd(),
    )
    assert "IMPORT_ORDER_OK" in out.stdout, (out.stdout, out.stderr[-2000:])
