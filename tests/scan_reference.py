"""Plain-JAX references for the grouped IVF bucket scan.

`per_pair_scan` scores every (query, probe) pair against its own gathered
copy of the bucket: B*nprobe*cap*D code bytes copied, cast and read. It is
the straightforward formulation the kernel in
vectorsearch_tpu/kernels/bucket_scan.py is checked against.

`grouped_scores_xla` is the kernel's own grouping written in plain JAX: a
`jnp.take` of each group's bucket, then a batched `dot_general` over
[G, QT, D] x [G, cap, D]. It drops into `bucket_scan.grouped_scores`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vectorsearch_tpu.kernels import cosine


def per_pair_scan(qn, buckets, counts, bucket_mask, probed, probe_valid, k):
    """(scores[B,k], global_slot[B,k]) over an explicit probe list."""
    b, nprobe = probed.shape
    _, cap, _ = buckets.codes.shape
    flat_probed = probed.reshape(b * nprobe)
    g_codes = jnp.take(buckets.codes, flat_probed, axis=0)  # [P, cap, D]
    q_rep = jnp.repeat(qn, nprobe, axis=0)  # [P, D]
    dots = jax.lax.dot_general(
        g_codes.astype(jnp.bfloat16),
        q_rep.astype(jnp.bfloat16),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [P, cap]
    qs_rep = jnp.repeat(jnp.sum(qn, axis=-1), nprobe)
    scores = (
        jnp.take(buckets.offset, flat_probed, axis=0) * qs_rep[:, None]
        + jnp.take(buckets.scale, flat_probed, axis=0) * dots
    ) * jnp.take(buckets.inv_norm, flat_probed, axis=0)
    col = jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1)
    valid = (col < jnp.take(counts, flat_probed)[:, None]) & jnp.take(
        bucket_mask, flat_probed, axis=0
    )
    if probe_valid is not None:
        valid = valid & probe_valid.reshape(b * nprobe, 1)
    scores = jnp.where(valid, scores, cosine.NEG_INF).reshape(b, nprobe * cap)
    k_eff = min(k, nprobe * cap)
    best, pos = jax.lax.top_k(scores, k_eff)
    cluster = jnp.take_along_axis(probed, pos // cap, axis=-1)
    gslot = cluster * cap + pos % cap
    if k_eff < k:
        best = jnp.pad(best, ((0, 0), (0, k - k_eff)), constant_values=cosine.NEG_INF)
        gslot = jnp.pad(gslot, ((0, 0), (0, k - k_eff)))
    return best, gslot


@functools.partial(jax.jit, static_argnames=("nprobe", "k"))
def per_pair_ivf_scan(queries, centroids_n, buckets, counts, bucket_mask, nprobe, k):
    """Probe + per_pair_scan, the signature of index.ivf._ivf_scan."""
    from vectorsearch_tpu.index.ivf import _probe

    qn = cosine.l2_normalize(queries.astype(jnp.float32))
    probed = _probe(qn, centroids_n, nprobe)
    return per_pair_scan(qn, buckets, counts, bucket_mask, probed, None, k)


def per_pair_transient_bytes(b, nprobe, kk, cap, d=768):
    """The per-pair gather holds [B*nprobe, cap, D] int8 codes plus their
    bf16 cast."""
    return b * nprobe * cap * (3 * d + 16)


def grouped_scores_xla(
    qg, qsum_g, grp_cluster, n_groups, codes, a, bv, bias, interpret=False
):
    """bucket_scan.grouped_scores in plain JAX: [G, QT, cap] scores."""
    del n_groups, interpret
    g_codes = jnp.take(codes, grp_cluster, axis=0)  # [G, cap, D]
    dots = jax.lax.dot_general(
        qg,
        g_codes.astype(jnp.bfloat16),
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [G, QT, cap]
    rows = lambda x: jnp.take(x, grp_cluster, axis=0)[:, None, :]  # noqa: E731
    return dots * rows(a) + qsum_g[..., None] * rows(bv) + rows(bias)
