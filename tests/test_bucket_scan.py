"""The grouped IVF bucket scan (kernels/bucket_scan.py) against plain
references: the Pallas kernel runs in interpret mode here; the compiled
kernel is checked on the card by the test marked `gpu` and by
chip_smoke.py's index phase."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scan_reference import grouped_scores_xla, per_pair_ivf_scan, per_pair_scan
from vectorsearch_tpu import constants
from vectorsearch_tpu.index import IVFIndex
from vectorsearch_tpu.index.ivf import _ivf_scan
from vectorsearch_tpu.kernels import bucket_scan, cosine
from vectorsearch_tpu.quant import layout


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(constants, "BUCKET_ROUND", 64)


def make_ivf(n_per=40, k=8, d=128, seed=2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 5
    pts = (centers[:, None, :] + rng.normal(size=(k, n_per, d))).astype(np.float32)
    v = pts.reshape(-1, d)
    packed = layout.pack_float(v)
    ids = np.arange(1, len(v) + 1, dtype=np.int64)
    return IVFIndex.build(packed, ids, centers), v


def scan_both(ivf, q, nprobe, k):
    args = (q, ivf.centroids_n, ivf.buckets, ivf.counts_dev, ivf.bucket_mask)
    got = _ivf_scan(*args, nprobe=nprobe, k=k)
    want = per_pair_ivf_scan(*args, nprobe=nprobe, k=k)
    return [np.asarray(x) for x in (*got, *want)]


# ------------------------------------------------------ agreement with refs


@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("d", [128, 40])
@pytest.mark.parametrize("nprobe", [1, 2, 8, 7])
def test_matches_per_pair(nprobe, d, k):
    """Same scores and slots as the per-pair reference at nprobe 1, 2, K
    and K-1; d=40 takes the masked last-column-block path."""
    ivf, v = make_ivf(d=d)
    q = jnp.asarray(v[:5] + 0.01, jnp.float32)
    s, g, s_ref, g_ref = scan_both(ivf, q, nprobe, k)
    np.testing.assert_allclose(s, s_ref, atol=1e-5)
    assert np.array_equal(g, g_ref)


@pytest.mark.parametrize("nprobe", [16, 64, 95])
def test_high_nprobe_exact(nprobe):
    """Many clusters probed per query: every group of a cluster and the
    single exact top-k over nprobe*cap columns must match the reference."""
    ivf, v = make_ivf(n_per=40, k=96, d=64)
    q = jnp.asarray(v[:17] + 0.01, jnp.float32)
    s, g, s_ref, g_ref = scan_both(ivf, q, nprobe, 10)
    np.testing.assert_allclose(s, s_ref, atol=1e-5)
    assert np.array_equal(g, g_ref)


@pytest.mark.parametrize("nprobe", [1, 3])
@pytest.mark.parametrize("b", [1, 7, 64])
def test_batch_shapes(b, nprobe):
    """Batch shapes that stress the group packer: one query, a partial
    group, and many queries per cluster (several groups per cluster)."""
    ivf, v = make_ivf(n_per=24, k=6, d=64)
    rng = np.random.default_rng(7)
    q = jnp.asarray(v[rng.integers(0, len(v), size=b)] + 0.01, jnp.float32)
    s, g, s_ref, g_ref = scan_both(ivf, q, nprobe, 4)
    np.testing.assert_allclose(s, s_ref, atol=1e-5)
    assert np.array_equal(g, g_ref)


@pytest.mark.parametrize("d", [128, 40, 8])
def test_kernel_matches_grouped_xla(d):
    """The kernel and the same grouping in plain JAX give the same
    [G, QT, cap] scores on every row the epilogue reads."""
    ivf, v = make_ivf(d=d)
    qn = cosine.l2_normalize(jnp.asarray(v[:9] + 0.01))
    probed = jnp.asarray(
        np.random.default_rng(d).integers(0, ivf.k_clusters, (9, 3)), jnp.int32
    )
    qt = bucket_scan.group_size(probed.size, ivf.k_clusters)
    grp, qidx, pair_slot, n_groups = bucket_scan.build_groups(
        probed, ivf.k_clusters, qt
    )
    args = (
        qn.astype(jnp.bfloat16)[qidx], jnp.sum(qn, axis=-1)[qidx], grp,
        n_groups, ivf.buckets.codes,
        *bucket_scan.row_terms(ivf.buckets, ivf.counts_dev, ivf.bucket_mask),
    )
    got = np.asarray(bucket_scan.grouped_scores(*args, interpret=True))
    want = np.asarray(grouped_scores_xla(*args))
    used = np.asarray(pair_slot)
    g_rows = got.reshape(-1, ivf.cap)[used]
    w_rows = want.reshape(-1, ivf.cap)[used]
    np.testing.assert_array_equal(np.isneginf(g_rows), np.isneginf(w_rows))
    fin = np.isfinite(w_rows)
    np.testing.assert_allclose(g_rows[fin], w_rows[fin], atol=1e-5)


# ------------------------------------------------------------ masking


@pytest.mark.parametrize("nprobe", [1, 2])
def test_masks_tombstones(nprobe):
    ivf, v = make_ivf(n_per=10, k=2)
    ivf = ivf.remove_ids(np.array([1]))  # tombstone the first data row
    q = jnp.asarray(v[:1] + 0.001, jnp.float32)
    s, gslot = _ivf_scan(
        q, ivf.centroids_n, ivf.buckets, ivf.counts_dev, ivf.bucket_mask,
        nprobe=nprobe, k=3,
    )
    flat_ids = ivf.ids.reshape(-1)
    got = flat_ids[np.clip(np.asarray(gslot), 0, flat_ids.size - 1)]
    assert 1 not in got[0][np.isfinite(np.asarray(s)[0])]
    assert np.isfinite(np.asarray(s)[0]).all()


@pytest.mark.parametrize("k", [4, 8, 64])
def test_k_larger_than_live(k):
    """Fewer live rows than k: the tail is -inf (never a padded slot)."""
    ivf, v = make_ivf(n_per=3, k=2)
    q = jnp.asarray(v[:1], jnp.float32)
    s, _ = _ivf_scan(
        q, ivf.centroids_n, ivf.buckets, ivf.counts_dev, ivf.bucket_mask,
        nprobe=1, k=k,
    )
    s = np.asarray(s)
    assert s.shape == (1, k)
    assert np.isfinite(s[0][:3]).all()
    assert np.isneginf(s[0][3:]).all()


@pytest.mark.parametrize("pattern", ["even", "odd", "none", "all"])
def test_probe_valid_masking(pattern):
    """Probe entries masked via probe_valid (the sharded path's non-owned
    clusters) never surface, and the rest match the per-pair reference."""
    ivf, v = make_ivf(n_per=40, k=16, d=64)
    q = jnp.asarray(v[:5] + 0.01, jnp.float32)
    qn = cosine.l2_normalize(q)
    kk = ivf.k_clusters
    probed = jnp.tile(jnp.arange(kk, dtype=jnp.int32), (5, 1))
    col = jnp.arange(kk) % 2
    valid = {
        "even": col == 0, "odd": col == 1,
        "none": jnp.zeros(kk, bool), "all": jnp.ones(kk, bool),
    }[pattern]
    probe_valid = jnp.tile(valid, (5, 1))
    args = (ivf.buckets, ivf.counts_dev, ivf.bucket_mask, probed, probe_valid, 8)
    s, g = bucket_scan.grouped_scan(qn, *args)
    s_ref, g_ref = per_pair_scan(qn, *args)
    s, g = np.asarray(s), np.asarray(g)
    fin = np.isfinite(s)
    assert bool(np.asarray(valid)[g[fin] // ivf.cap].all())
    np.testing.assert_allclose(s, np.asarray(s_ref), atol=1e-5)
    assert np.array_equal(g[fin], np.asarray(g_ref)[fin])
    if pattern == "none":
        assert not fin.any()


# -------------------------------------------------------------- refine


@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_refine_parity(nprobe):
    """IVFIndex.search(refine=m) equals the per-pair coarse scan followed
    by the same exact-f32 rescore."""
    ivf, v = make_ivf()
    q = jnp.asarray(v[:6] + 0.01, jnp.float32)
    s, ids = ivf.search(q, k=5, nprobe=nprobe, refine=16)
    cs, cg = per_pair_ivf_scan(
        q, ivf.centroids_n, ivf.buckets, ivf.counts_dev, ivf.bucket_mask,
        nprobe=nprobe, k=16,
    )
    d = ivf.dim
    flat = layout.PackedVectors(
        ivf.buckets.codes.reshape(-1, d), ivf.buckets.scale.reshape(-1),
        ivf.buckets.offset.reshape(-1), ivf.buckets.inv_norm.reshape(-1),
    )
    rs, rg = cosine.rescore_topk(q, flat, cs, cg, 5)
    flat_ids = ivf.ids.reshape(-1)
    np.testing.assert_allclose(s, np.asarray(rs), atol=1e-6)
    assert np.array_equal(ids, flat_ids[np.asarray(rg)])
    assert (ids[:, 0] == np.arange(1, 7)).all()


# ------------------------------------------------------- group building


@pytest.mark.parametrize("seed", range(6))
def test_build_groups_cover_pairs(seed):
    """Every (query, cluster) pair lands in exactly one group slot of its
    own cluster, groups hold at most qt pairs, n_groups counts them."""
    rng = np.random.default_rng(seed)
    kk = int(rng.integers(2, 40))
    b = int(rng.integers(1, 50))
    nprobe = int(rng.integers(1, kk + 1))
    probed = np.stack([rng.choice(kk, nprobe, replace=False) for _ in range(b)])
    qt = bucket_scan.group_size(b * nprobe, kk)
    grp, qidx, pair_slot, n_groups = jax.device_get(
        bucket_scan.build_groups(jnp.asarray(probed, jnp.int32), kk, qt)
    )
    pair_slot = np.asarray(pair_slot)
    assert len(set(pair_slot.tolist())) == b * nprobe
    g_of_pair, s_of_pair = pair_slot // qt, pair_slot % qt
    flat = probed.reshape(-1)
    q_of_pair = np.arange(b * nprobe) // nprobe
    assert (np.asarray(grp)[g_of_pair] == flat).all()
    assert (np.asarray(qidx)[g_of_pair, s_of_pair] == q_of_pair).all()
    _, per_cluster = np.unique(flat, return_counts=True)
    assert int(n_groups) == int(np.sum(-(-per_cluster // qt)))
    assert g_of_pair.max() < int(n_groups) <= len(grp)


@pytest.mark.parametrize(
    "p,kk,qt",
    [(1, 1000, 16), (512, 1000, 16), (4096, 1000, 16), (32768, 1000, 32),
     (100, 2, 32)],
)
def test_group_size(p, kk, qt):
    """QT ~ 2x the mean pairs per cluster, within [16, 32] (16 is the
    least Triton's dot takes)."""
    assert bucket_scan.group_size(p, kk) == qt


@pytest.mark.parametrize(
    "n,limit,want", [(3072, 128, 128), (192, 128, 64), (64, 128, 64),
                     (768, 128, 128), (40, 128, 8)],
)
def test_pow2_divisor(n, limit, want):
    """Tile rows: the largest power of two that divides the bucket
    capacity, up to the tile limit."""
    assert bucket_scan._pow2_divisor(n, limit) == want


def test_transient_bytes_grows_with_batch():
    sizes = [bucket_scan.transient_bytes(b, 8, 1000, 3072) for b in (1, 64, 512)]
    assert sizes == sorted(sizes) and sizes[0] > 0
    # 1M-corpus shape, B=512, nprobe=8: 1256 groups of 16 + 4096 pairs
    assert sizes[2] == (1256 * 16 + 4096) * 3072 * 4


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
def test_kernel_compiles_on_gpu(gpu):
    """The compiled Triton kernel at the 768-wide production shape agrees
    with the plain grouped reference."""
    rng = np.random.default_rng(0)
    kk, cap, d, b, nprobe = 64, 1024, 768, 64, 4
    codes = jnp.asarray(rng.integers(-127, 128, (kk, cap, d)), jnp.int8)
    buckets = layout.PackedVectors(
        codes, jnp.full((kk, cap), 0.01), jnp.zeros((kk, cap)),
        jnp.full((kk, cap), 0.1),
    )
    counts = jnp.full((kk,), cap, jnp.int32)
    mask = jnp.ones((kk, cap), bool)
    qn = cosine.l2_normalize(jnp.asarray(rng.normal(size=(b, d)), jnp.float32))
    probed = jnp.asarray(rng.integers(0, kk, (b, nprobe)), jnp.int32)
    qt = bucket_scan.group_size(b * nprobe, kk)
    grp, qidx, pair_slot, n_groups = bucket_scan.build_groups(probed, kk, qt)
    args = (
        qn.astype(jnp.bfloat16)[qidx], jnp.sum(qn, axis=-1)[qidx], grp,
        n_groups, codes, *bucket_scan.row_terms(buckets, counts, mask),
    )
    got = np.asarray(bucket_scan.grouped_scores(*args)).reshape(-1, cap)
    want = np.asarray(grouped_scores_xla(*args)).reshape(-1, cap)
    rows = np.asarray(pair_slot)
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "shape,wide", [((1000, 3072, 768), True), ((64, 1024, 768), False)]
)
def test_large_refs_take_64bit_offsets(monkeypatch, shape, wide):
    """Refs over 2**31 bytes reach the Triton lowering's offset computation
    with a dtype wide enough to select its 64-bit path (> 2**32 bytes);
    smaller refs pass unchanged."""
    from jax._src import core as jax_core
    from jax._src.pallas.triton import lowering

    seen = []
    monkeypatch.setattr(
        lowering, "_compute_offsets_from_indices",
        lambda info, indexer: seen.append(info.full_shape_dtype),
    )
    bucket_scan._wide_offsets_for_large_refs()  # wraps the recorder
    info = lowering.BlockInfo(
        jax_core.ShapedArray(shape, jnp.int8), [None] * 3, [1] * 3, shape
    )
    lowering._compute_offsets_from_indices(info, None)
    (got,) = seen
    assert got.shape == shape
    assert (np.prod(shape) * np.dtype(got.dtype).itemsize > 2**32) == wide


def test_kernel_lowers_for_cuda():
    """The kernel lowers to Triton IR for the GPU from any host (the
    CUDA toolchain itself only runs on the card)."""
    from vectorsearch_tpu.quant.layout import PackedVectors

    S = jax.ShapeDtypeStruct
    kk, cap, d, b, nprobe = 1000, 3072, 768, 64, 8

    def f(qn, codes, scale, offset, inv, counts, mask, probed):
        buckets = PackedVectors(codes, scale, offset, inv)
        return bucket_scan.grouped_scan(
            qn, buckets, counts, mask, probed, None, 64
        )

    args = (
        S((b, d), jnp.float32), S((kk, cap, d), jnp.int8),
        *[S((kk, cap), jnp.float32)] * 3, S((kk,), jnp.int32),
        S((kk, cap), jnp.bool_), S((b, nprobe), jnp.int32),
    )
    import unittest.mock as mock

    with mock.patch.object(bucket_scan, "_interpret", lambda: False):
        text = jax.jit(f).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "ivf_bucket_scan" in text
