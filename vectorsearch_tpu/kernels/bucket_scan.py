"""Cluster-grouped IVF bucket scan: a Pallas kernel on the Triton route.

A search probes nprobe clusters per query. Scoring each (query, probe)
pair against its own gathered copy of the bucket reads B*nprobe*cap*D
code bytes; at 1M x 768 (K~1000, cap=3072, B=512, nprobe=8) that is
~9.7 G elements per batch. Queries that probe the same cluster can share
one read instead: the (query, cluster) pairs are sorted by cluster and
packed into groups of QT query rows, and each group reads its bucket once
through a per-group cluster index, with no gathered copy in device memory.
The scan is memory-bound (2*QT operations per code byte), so the bytes it
does not move are the whole gain.

Affine identity per row r of a probed bucket and query q
(quant/layout.py):

    score[q, r] = a[r] * <codes[r], qn[q]> + bv[r] * qsum[q] + bias[r]
      a    = scale * inv_norm
      bv   = offset * inv_norm
      bias = 0 for live rows, -inf for padding and tombstones

The dots run bf16 x bf16 -> f32 (int8 codes are exact in bf16); the bf16
query rounding is removed by the exact-f32 refine that follows
(cosine.rescore_topk).

One program handles one (group, tile of bucket rows): it loads its cluster
id from `grp_cluster`, its [QT, D] query group, and [tile, bk] slices of
the int8 codes at that cluster, converts the codes in registers and
accumulates `pl.dot` in f32 over D. Programs of the padding groups past
the used count exit at once. The scores land as [G, QT, cap]; the
epilogue gathers them back into pair order and takes one exact top-k over
each query's nprobe*cap candidates.

Replaces the reference's per-batch SQL scan hot loop
(server/search.go:241-273).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..quant.layout import PackedVectors
from . import cosine

QT_MIN = 16  # Triton's dot needs at least 16 rows
QT_MAX = 32  # query rows per group: read sharing vs padding waste
TILE_MAX = 128  # bucket rows per program
BK_MAX = 128  # code columns per dot step
NUM_WARPS = 4
NUM_STAGES = 3


def _wide_offsets_for_large_refs() -> None:
    """Pallas's Triton lowering (JAX 0.9) computes load offsets in signed
    32-bit unless a ref exceeds 2**32 bytes, so a ref of 2-4 GiB (the
    1M x 768 int8 bucket store is 2.4 GB) is read at wrong addresses past
    2**31. Refs above 2**31 bytes are sent to its 64-bit path by reporting
    a wider dtype to the offset computation: strides are counted in
    elements there, and the dtype only feeds the size test."""
    from jax._src.pallas.triton import lowering

    orig = getattr(lowering, "_compute_offsets_from_indices", None)
    if orig is None or getattr(orig, "_wide_for_large_refs", False):
        return

    def offsets(block_info, nd_indexer):
        sd = block_info.full_shape_dtype
        if math.prod(sd.shape) * np.dtype(sd.dtype).itemsize > 2**31:
            block_info = dataclasses.replace(
                block_info, full_shape_dtype=sd.update(dtype=np.dtype(np.complex128))
            )
        return orig(block_info, nd_indexer)

    offsets._wide_for_large_refs = True
    lowering._compute_offsets_from_indices = offsets


def _pow2_divisor(n: int, limit: int) -> int:
    """Largest power of two <= limit that divides n."""
    t = 1
    while t * 2 <= limit and n % (t * 2) == 0:
        t *= 2
    return t


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def group_size(p: int, kk: int) -> int:
    """Query rows per group: ~2x the mean pairs per cluster keeps most
    groups full without padding waste, bounded to [QT_MIN, QT_MAX]."""
    return max(QT_MIN, min(QT_MAX, _next_pow2(-(-2 * p // kk))))


def build_groups(probed: jax.Array, kk: int, qt: int):
    """Pack (query, cluster) pairs into groups of qt rows per cluster.

    probed: int32 [B, nprobe]. Returns
      grp_cluster int32 [G]      cluster id of each group (0 past n_groups)
      qidx        int32 [G, qt]  query row of each group slot
      pair_slot   int32 [P]      flat pair -> row of the [G*qt, cap] grid
      n_groups    int32 []       groups in use
    with G = P // qt + min(K, P), which bounds sum_c ceil(m_c / qt).
    """
    b, nprobe = probed.shape
    p = b * nprobe
    g_max = p // qt + min(kk, p)

    flat_c = probed.reshape(p).astype(jnp.int32)
    q_of_pair = jnp.arange(p, dtype=jnp.int32) // nprobe
    order = jnp.argsort(flat_c)  # stable
    sc = flat_c[order]
    sq = q_of_pair[order]
    idx = jnp.arange(p, dtype=jnp.int32)
    new_cluster = jnp.concatenate([jnp.ones((1,), bool), sc[1:] != sc[:-1]])
    seg_start = jax.lax.cummax(jnp.where(new_cluster, idx, 0))
    rank = idx - seg_start
    new_group = new_cluster | (rank % qt == 0)
    gid = jnp.cumsum(new_group.astype(jnp.int32)) - 1  # [P]
    pc = gid * qt + rank % qt  # strictly increasing over sorted pairs

    # non-starts scatter to distinct out-of-bounds slots so the
    # unique-indices promise holds for the dropped updates too
    start_idx = jnp.where(new_group, gid, g_max + idx)
    grp_cluster = (
        jnp.zeros((g_max,), jnp.int32)
        .at[start_idx]
        .set(sc, mode="drop", unique_indices=True)
    )
    qidx = (
        jnp.zeros((g_max * qt,), jnp.int32)
        .at[pc]
        .set(sq, indices_are_sorted=True, unique_indices=True)
        .reshape(g_max, qt)
    )
    pair_slot = jnp.zeros((p,), jnp.int32).at[order].set(pc, unique_indices=True)
    return grp_cluster, qidx, pair_slot, gid[-1] + 1


def row_terms(buckets: PackedVectors, counts: jax.Array, bucket_mask: jax.Array):
    """Per-slot (a, bv, bias) [K, cap] of the affine identity above."""
    kk, cap = bucket_mask.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (kk, cap), 1)
    valid = (col < counts[:, None]) & bucket_mask
    a = buckets.scale * buckets.inv_norm
    bv = buckets.offset * buckets.inv_norm
    bias = jnp.where(valid, 0.0, cosine.NEG_INF)
    return a, bv, bias


def _scan_kernel(
    ngrp_ref,  # i32 [1]        groups in use
    gcl_ref,  # i32 [G]         cluster id per group
    qg_ref,  # bf16 [QT, Dp]    this group's query rows (zero-padded to Dp)
    qsum_ref,  # f32 [QT]       per-query sum
    codes_ref,  # i8 [K, cap, D] the whole bucket store
    a_ref,  # f32 [K, cap]
    bv_ref,  # f32 [K, cap]
    bias_ref,  # f32 [K, cap]
    out_ref,  # f32 [QT, tile]
    *,
    bk: int,
    d: int,
):
    g = pl.program_id(0)
    t = pl.program_id(1)
    qt, tile = out_ref.shape
    n_k = -(-d // bk)

    @pl.when(g < ngrp_ref[0])
    def _():
        c = gcl_ref[g]
        rows = pl.ds(t * tile, tile)

        def body(i, acc):
            cols = pl.ds(i * bk, bk)
            q = qg_ref[:, cols]
            if d % bk:
                col = i * bk + jax.lax.broadcasted_iota(jnp.int32, (tile, bk), 1)
                x = plgpu.load(codes_ref.at[c, rows, cols], mask=col < d, other=0)
            else:
                x = codes_ref[c, rows, cols]
            return acc + pl.dot(q, x.astype(jnp.bfloat16), trans_b=True)

        acc = jax.lax.fori_loop(
            0, n_k, body, jnp.zeros((qt, tile), jnp.float32)
        )
        out_ref[...] = (
            acc * a_ref[c, rows][None, :]
            + qsum_ref[...][:, None] * bv_ref[c, rows][None, :]
            + bias_ref[c, rows][None, :]
        )


def grouped_scores(
    qg: jax.Array,
    qsum_g: jax.Array,
    grp_cluster: jax.Array,
    n_groups: jax.Array,
    codes: jax.Array,
    a: jax.Array,
    bv: jax.Array,
    bias: jax.Array,
    interpret: bool = False,
) -> jax.Array:
    """Scores [G, QT, cap] of each group's queries against its bucket."""
    _wide_offsets_for_large_refs()
    g_max, qt, d = qg.shape
    _, cap, _ = codes.shape
    tile = _pow2_divisor(cap, TILE_MAX)
    bk = min(BK_MAX, max(QT_MIN, _next_pow2(d)))
    dp = -(-d // bk) * bk
    if dp != d:
        qg = jnp.pad(qg, ((0, 0), (0, 0), (0, dp - d)))
    return pl.pallas_call(
        functools.partial(_scan_kernel, bk=bk, d=d),
        out_shape=jax.ShapeDtypeStruct((g_max, qt, cap), jnp.float32),
        grid=(g_max, cap // tile),
        in_specs=[
            pl.no_block_spec,
            pl.no_block_spec,
            pl.BlockSpec((None, qt, dp), lambda g, t: (g, 0, 0)),
            pl.BlockSpec((None, qt), lambda g, t: (g, 0)),
        ] + [pl.no_block_spec] * 4,
        out_specs=pl.BlockSpec((None, qt, tile), lambda g, t: (g, 0, t)),
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        backend="triton",
        interpret=interpret,
        name="ivf_bucket_scan",
    )(
        jnp.reshape(n_groups, (1,)).astype(jnp.int32), grp_cluster, qg,
        qsum_g, codes, a, bv, bias,
    )


def _interpret() -> bool:
    """The Triton route compiles only for the GPU; elsewhere (the CPU test
    mesh) the same kernel runs in Pallas interpret mode."""
    return jax.default_backend() != "gpu"


def grouped_scan(
    qn: jax.Array,
    buckets: PackedVectors,
    counts: jax.Array,
    bucket_mask: jax.Array,
    probed: jax.Array,
    probe_valid: jax.Array | None,
    k: int,
):
    """Bucket scan over an explicit probe list.

    qn: f32 [B, D] normalized queries.
    probed: int32 [B, m] cluster ids per query; probe_valid: bool [B, m]
    or None (False entries are scanned but fully masked — the sharded path
    passes the clusters a device owns this way). Returns (scores[B,k],
    global_slot[B,k]) with global_slot = cluster*cap + slot; -inf rows
    carry the slot of a masked candidate."""
    b, nprobe = probed.shape
    kk, cap, _ = buckets.codes.shape
    p = b * nprobe
    qt = group_size(p, kk)
    grp_cluster, qidx, pair_slot, n_groups = build_groups(probed, kk, qt)
    qg = qn.astype(jnp.bfloat16)[qidx]  # [G, QT, D]
    qsum_g = jnp.sum(qn, axis=-1)[qidx]  # [G, QT]
    a, bv, bias = row_terms(buckets, counts, bucket_mask)
    out = grouped_scores(
        qg, qsum_g, grp_cluster, n_groups, buckets.codes, a, bv, bias,
        interpret=_interpret(),
    )
    g_max = out.shape[0]
    pair_scores = out.reshape(g_max * qt, cap)[pair_slot]  # [P, cap]
    if probe_valid is not None:
        pair_scores = jnp.where(
            probe_valid.reshape(p, 1), pair_scores, cosine.NEG_INF
        )
    k_eff = min(k, nprobe * cap)
    best, pos = jax.lax.top_k(pair_scores.reshape(b, nprobe * cap), k_eff)
    cluster = jnp.take_along_axis(probed, pos // cap, axis=-1)
    gslot = cluster * cap + pos % cap
    if k_eff < k:
        best = jnp.pad(best, ((0, 0), (0, k - k_eff)), constant_values=cosine.NEG_INF)
        gslot = jnp.pad(gslot, ((0, 0), (0, k - k_eff)))
    return best, gslot


def transient_bytes(b: int, nprobe: int, kk: int, cap: int) -> int:
    """Device scratch of one grouped_scan dispatch: the [G*QT, cap] score
    grid plus its [P, cap] pair-order gather (f32)."""
    p = b * nprobe
    qt = group_size(p, kk)
    g_max = p // qt + min(kk, p)
    return (g_max * qt + p) * cap * 4
