"""IVF-Flat index: HBM-resident packed cluster buckets + probe/scan.

Replaces the reference's SQL-side IVF (probe over centroid rows cached 5s,
then `FindInBatches` over `centroid_id IN probed` — server/search.go:202-273)
with a device-resident layout:

  centroids  f32[K, D]
  buckets    PackedVectors of shape [K, cap, D] / [K, cap]  (uniform padded
             capacity, counts mask the tail — static shapes for XLA)
  ids        host int64[K, cap]  slot -> external id
  spill      FlatIndex overflow tail for clusters that outgrow `cap`
             (searched alongside; drained by the next rebuild)

Query path: centroid top-nprobe probe (one small matmul) -> gather probed
buckets -> batched per-query scoring via the affine identity -> masked top-k
over nprobe*cap candidates -> merge with spill hits.

Insert path (append-without-rebuild, reference: server/upload.go:240-246):
nearest-centroid assign on device, host slot allocation from counts, one
scatter into donated bucket buffers; overflow rows go to the spill index.
Global structure is only repaired by the next rebuild
(reference: server/centroids.go:17 RefreshCentroids).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..kernels import bucket_scan, cosine
from ..quant.layout import PackedVectors
from .flat import FlatIndex, _coord_class, round_capacity


def bucket_capacity(max_count: int, headroom: float = 1.25) -> int:
    """Uniform bucket capacity rounded to constants.BUCKET_ROUND.

    Default 25% headroom for streaming inserts; read-heavy deployments at
    device-memory-limit scale pass headroom=1.0 — overflow inserts still
    work via the spill tail."""
    need = max(1, int(max_count * headroom))
    return ((need + constants.BUCKET_ROUND - 1) // constants.BUCKET_ROUND) * constants.BUCKET_ROUND


def _probe(qn: jax.Array, centroids_n: jax.Array, nprobe: int) -> jax.Array:
    """Top-nprobe cluster ids [B, nprobe] by bf16 centroid similarity."""
    sims = jnp.dot(
        qn.astype(jnp.bfloat16),
        centroids_n.astype(jnp.bfloat16).T,
        preferred_element_type=jnp.float32,
    )
    return jax.lax.top_k(sims, nprobe)[1]


@functools.partial(jax.jit, static_argnames=("nprobe", "k"))
def _ivf_scan(
    queries: jax.Array,
    centroids_n: jax.Array,
    buckets: PackedVectors,
    counts: jax.Array,
    bucket_mask: jax.Array,
    nprobe: int,
    k: int,
):
    """Fused probe + grouped bucket scan. Returns (scores[B,k],
    global_slot[B,k]).

    global_slot = cluster * cap + slot_in_cluster; -inf rows carry slot of a
    masked candidate (caller nulls them by score).
    """
    qn = cosine.l2_normalize(queries.astype(jnp.float32))
    probed = _probe(qn, centroids_n, nprobe)
    return bucket_scan.grouped_scan(
        qn, buckets, counts, bucket_mask, probed, None, k
    )


@jax.jit
def _scatter_rows(
    buckets: PackedVectors,
    bucket_mask: jax.Array,
    cid: jax.Array,
    slot: jax.Array,
    rows: PackedVectors,
):
    """Scatter new rows into (cid, slot); out-of-bounds slots are dropped
    (JAX scatter semantics), which is how padded/overflow rows are elided.
    Not donated: old index snapshots must remain readable (see flat.py)."""
    return (
        PackedVectors(
            codes=buckets.codes.at[cid, slot].set(rows.codes),
            scale=buckets.scale.at[cid, slot].set(rows.scale),
            offset=buckets.offset.at[cid, slot].set(rows.offset),
            inv_norm=buckets.inv_norm.at[cid, slot].set(rows.inv_norm),
        ),
        bucket_mask.at[cid, slot].set(True),
    )


@jax.jit
def _clear_bucket_slots(bucket_mask: jax.Array, cid: jax.Array, slot: jax.Array):
    """Tombstone (cid, slot) coordinates; out-of-bounds pads are dropped."""
    return bucket_mask.at[cid, slot].set(False, mode="drop")


@functools.partial(jax.jit, static_argnames=("step",))
def _slice_clusters(arr: jax.Array, start, step: int):
    """One compiled program serves every chunk of a cluster-range export:
    eager basic slicing (`arr[c0:c1]`) bakes each offset into its own
    executable, one compile per chunk."""
    return jax.lax.dynamic_slice_in_dim(arr, start, step, axis=0)


@functools.partial(jax.jit, static_argnames=("nprobe", "k_coarse", "k"))
def _scan_refined(
    queries, centroids_n, buckets, counts, bucket_mask, nprobe, k_coarse, k
):
    """Coarse grouped scan + exact-f32 refine fused into ONE jitted
    program; the bucket flat view is reshaped inside jit (a view, not an
    eager copy)."""
    scores, gslot = _ivf_scan(
        queries, centroids_n, buckets, counts, bucket_mask,
        nprobe=nprobe, k=k_coarse,
    )
    d = buckets.codes.shape[-1]
    flat_view = PackedVectors(
        codes=buckets.codes.reshape(-1, d),
        scale=buckets.scale.reshape(-1),
        offset=buckets.offset.reshape(-1),
        inv_norm=buckets.inv_norm.reshape(-1),
    )
    return cosine.rescore_topk(queries, flat_view, scores, gslot, k)


OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Ran out of memory", "out of memory")
OOM_RETRIES = 3


def _oom_fallback(b_max: int) -> int | None:
    """Batch bound for the retry after an out-of-memory dispatch: half the
    last one, or None once a single query did not fit."""
    if b_max <= 1:
        return None
    return max(1, b_max // 2)


@functools.partial(jax.jit, static_argnames=("k_coarse", "k", "chunk", "refine"))
def _exhaustive_refined(
    queries, buckets, bucket_mask, k_coarse, k, chunk=65_536, refine=True
):
    """nprobe=ALL without a probe: stream the resident bucket store.

    Probing every cluster through the grouped scan would re-read the whole
    store once per query group and build a [G*QT, cap] score grid.
    Scanning everything needs no probe, no group build, and no gather:
    flatten the bucket store IN PLACE ([K, cap, D] -> [K*cap, D] collapses
    major dims) and run the streamed carried-top-k scan over it, then
    exact-f32 rescore. One jitted program, one D2H in the caller. This is
    the reference's centroids=-1 "scan the whole category" fallback
    (server/search.go:116-122); dead slots are masked via the flattened
    bucket mask."""
    d = buckets.codes.shape[-1]
    flat_view = PackedVectors(
        codes=buckets.codes.reshape(-1, d),
        scale=buckets.scale.reshape(-1),
        offset=buckets.offset.reshape(-1),
        inv_norm=buckets.inv_norm.reshape(-1),
    )
    mask = bucket_mask.reshape(-1)
    n = flat_view.n
    s, idx = cosine.scan_topk_streamed(
        queries, flat_view, jnp.int32(n), k=k_coarse, chunk=chunk,
        valid_mask=mask,
    )
    if not refine:
        return s[:, :k], idx[:, :k]
    return cosine.rescore_topk(queries, flat_view, s, idx, k, valid=mask)


@dataclass(frozen=True)
class IVFIndex:
    """IVF-Flat index over packed cluster buckets.

    `counts`/`ids` live on the host (slot allocation is a host decision);
    `counts_dev` mirrors counts on device for the scan.
    """

    centroids: jax.Array  # f32 [K, D]
    centroids_n: jax.Array  # f32 [K, D], L2-normalized rows
    buckets: PackedVectors  # [K, cap, D] / [K, cap]
    bucket_mask: jax.Array  # bool [K, cap]
    mask_host: np.ndarray  # host mirror of bucket_mask (mutations/exports
    #   never read the device mask back: no synchronous D2H on the
    #   upload path)
    counts: np.ndarray  # host int32 [K]
    counts_dev: jax.Array  # device int32 [K]
    ids: np.ndarray  # host int64 [K, cap]
    spill: FlatIndex
    # host-tracked count of live bucket rows: n_live must not cost a
    # device mask transfer on the upload hot path
    live_count: int = 0
    # True when the bucket store is too large for functional updates: the
    # non-donated scatter (kept so lock-free readers can hold old
    # snapshots) needs a SECOND copy of the codes, which cannot exist at
    # device-memory-limit scale (streaming insert -> RESOURCE_EXHAUSTED).
    # Frozen buckets route every
    # insert to the spill tail; tombstone deletes still work (the mask
    # copy is small); the next full rebuild re-packs
    frozen: bool = False

    @property
    def k_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.buckets.codes.shape[1]

    @property
    def dim(self) -> int:
        return self.centroids.shape[-1]

    @property
    def n_live(self) -> int:
        return self.live_count + self.spill.live

    # ---- construction ----

    @staticmethod
    def build(
        packed: PackedVectors,
        ids: np.ndarray,
        centroids: np.ndarray,
        assignments: np.ndarray | None = None,
        assign_chunk: int = 65_536,
        headroom: float = 1.25,
        hbm_budget: int | None = None,
    ) -> "IVFIndex":
        """Build buckets from a full corpus + centroids (rebuild path).

        Assignment runs on device in chunks; bucket packing is a host-side
        vectorized scatter (one pass), then a single device_put per array.

        hbm_budget (bytes): cap on the packed footprint. Bucket headroom
        degrades toward 1.0 until the projected codes+sidecars fit —
        the engine-level capacity policy that lets the default 25%
        streaming-insert headroom coexist with corpora at the device
        memory limit (10M x 768 at 1.25 is ~19.4 GB). Below
        1.0 there is nothing left to shrink: every stored row needs a
        slot; the overflow path is the spill tail, and the build proceeds
        with a warning.
        """
        packed = PackedVectors(*[np.asarray(a) for a in packed])
        n, d = packed.codes.shape
        kk = centroids.shape[0]
        ids = np.asarray(ids, np.int64)

        if assignments is None:
            assignments = assign_clusters(packed, centroids, chunk=assign_chunk)
        assignments = np.asarray(assignments, np.int32)

        counts = np.bincount(assignments, minlength=kk).astype(np.int32)
        max_count = int(counts.max()) if n else 1
        cap = bucket_capacity(max_count, headroom)
        if hbm_budget is not None:
            # int8 code bytes + 3 f32 sidecars + device bool mask per slot
            bytes_per_slot = d + 13
            # reserve the empty spill tail's fixed allocation (hbm_bytes
            # counts it, so the budget must too or the invariant
            # hbm_bytes <= budget breaks right at the boundary)
            bucket_budget = max(
                0, hbm_budget - constants.BUCKET_ROUND * bytes_per_slot
            )
            floor_cap = bucket_capacity(max_count, 1.0)
            fit_cap = (bucket_budget // (kk * bytes_per_slot)) if kk else cap
            fit_cap = (fit_cap // constants.BUCKET_ROUND) * constants.BUCKET_ROUND
            clamped = max(floor_cap, min(cap, fit_cap))
            if clamped != cap:
                from ..logger import sugar

                sugar().info(
                    "bucket capacity %d -> %d to fit HBM budget %.2f GB "
                    "(K=%d, projected %.2f GB)",
                    cap, clamped, hbm_budget / 2**30, kk,
                    kk * clamped * bytes_per_slot / 2**30,
                )
                cap = clamped
            if kk * cap * bytes_per_slot > bucket_budget:
                from ..logger import sugar

                sugar().warning(
                    "packed index %.2f GB exceeds HBM budget %.2f GB even "
                    "at headroom 1.0 (K=%d, cap=%d)",
                    kk * cap * bytes_per_slot / 2**30,
                    hbm_budget / 2**30, kk, cap,
                )

        order = np.argsort(assignments, kind="stable")
        sorted_cid = assignments[order]
        # slot within cluster = position in sorted run
        starts = np.zeros(kk + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(n, dtype=np.int64) - starts[sorted_cid]

        big = n >= 4_000_000  # log phases at scale (boot observability)
        if big:
            from ..logger import sugar

            import time as _t

            _t0 = _t.perf_counter()

        def scatter(field, fill=0):
            src = np.asarray(field)
            out_shape = (kk, cap) + src.shape[1:]
            out = np.full(out_shape, fill, dtype=src.dtype)
            out[sorted_cid, slot] = src[order]
            return out

        buckets = PackedVectors(
            codes=jnp.asarray(scatter(packed.codes)),
            scale=jnp.asarray(scatter(packed.scale)),
            offset=jnp.asarray(scatter(packed.offset)),
            inv_norm=jnp.asarray(scatter(packed.inv_norm)),
        )
        if big:
            sugar().info(
                "ivf build: bucket scatter+upload queued %.1fs (K=%d cap=%d)",
                _t.perf_counter() - _t0, kk, cap,
            )
        bucket_mask = np.zeros((kk, cap), np.bool_)
        bucket_mask[sorted_cid, slot] = True
        id_grid = np.zeros((kk, cap), np.int64)
        id_grid[sorted_cid, slot] = ids[order]

        cents = jnp.asarray(centroids, jnp.float32)
        frozen = (
            hbm_budget is not None
            and 2 * kk * cap * (d + 13)
            > hbm_budget - constants.BUCKET_ROUND * (d + 13)
        )
        if frozen:
            from ..logger import sugar

            sugar().info(
                "bucket store frozen (2x%.1f GB copies exceed the %.1f GB "
                "budget): streaming inserts go to the spill tail",
                kk * cap * (d + 13) / 2**30, hbm_budget / 2**30,
            )
        return IVFIndex(
            centroids=cents,
            centroids_n=cosine.l2_normalize(cents),
            buckets=buckets,
            bucket_mask=jnp.asarray(bucket_mask),
            mask_host=bucket_mask,
            counts=counts,
            counts_dev=jnp.asarray(counts),
            ids=id_grid,
            spill=FlatIndex.create(d),
            live_count=n,
            frozen=frozen,
        )

    # ---- queries ----

    def search(self, queries, k: int, nprobe: int = 1, refine: int = 0):
        """Top-k over probed clusters + spill. Returns (scores, ids) like
        FlatIndex.search. nprobe<0 means probe everything
        (reference: server/search.go:118-122). refine=m>0 re-ranks the
        coarse top-m candidates with the exact f32 query (recall lift)."""
        queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
        if nprobe < 0:
            nprobe = self.k_clusters
        nprobe = max(1, min(nprobe, self.k_clusters))
        k_coarse = max(k, refine) if refine else k
        exhaustive = nprobe == self.k_clusters

        n_q = int(queries.shape[0])
        b_max = n_q
        if not exhaustive:
            # split the batch so one dispatch's score grid stays within
            # the transient budget (the streamed exhaustive scan holds one
            # [B, chunk] tile, so B does not threaten memory there)
            budget = 2 << 30
            while b_max > 1 and bucket_scan.transient_bytes(
                b_max, nprobe, self.k_clusters, self.cap
            ) > budget:
                b_max = (b_max + 1) // 2

        def one(qs):
            if exhaustive:
                return _exhaustive_refined(
                    qs, self.buckets, self.bucket_mask,
                    k_coarse=k_coarse, k=k if refine else k_coarse,
                    refine=bool(refine),
                )
            if refine:
                return _scan_refined(
                    qs, self.centroids_n, self.buckets, self.counts_dev,
                    self.bucket_mask, nprobe=nprobe, k_coarse=k_coarse, k=k,
                )
            return _ivf_scan(
                qs, self.centroids_n, self.buckets, self.counts_dev,
                self.bucket_mask, nprobe=nprobe, k=k_coarse,
            )

        def dispatch(bm):
            parts = [one(queries[i : i + bm]) for i in range(0, n_q, bm)]
            if len(parts) == 1:
                return jax.device_get(parts[0])
            s = jnp.concatenate([p[0] for p in parts], axis=0)
            g = jnp.concatenate([p[1] for p in parts], axis=0)
            return jax.device_get((s, g))  # one transfer

        # The static budget cannot see the memory actually free: on an
        # out-of-memory failure, halve the dispatch batch, at most
        # OOM_RETRIES times, so a deterministic failure still surfaces.
        for attempt in range(OOM_RETRIES + 1):
            try:
                scores, gslot = dispatch(b_max)
                break
            except Exception as e:  # noqa: BLE001 — inspect and re-raise
                msg = str(e)
                if attempt == OOM_RETRIES or not any(
                    t in msg for t in OOM_MARKERS
                ):
                    raise
                b_max = _oom_fallback(b_max)
                if b_max is None:
                    raise
                from ..logger import sugar

                sugar().warning(
                    "ivf.search: dispatch failed (%s...); retrying with "
                    "halved batch b_max=%d", msg[:120], b_max,
                )
        flat_ids = self.ids.reshape(-1)
        safe = np.clip(gslot, 0, flat_ids.size - 1)
        out_ids = np.where(np.isneginf(scores), -1, flat_ids[safe])

        if self.spill.live > 0:
            s2, i2 = self.spill.search(queries, k, refine=refine)
            both_s = np.concatenate([scores, s2], axis=-1)
            both_i = np.concatenate([out_ids, i2], axis=-1)
            take = np.argsort(-both_s, axis=-1, kind="stable")[:, :k]
            scores = np.take_along_axis(both_s, take, axis=-1)
            out_ids = np.take_along_axis(both_i, take, axis=-1)
        return scores, out_ids

    def probe(self, queries, nprobe: int):
        """Centroid similarities + top-nprobe cluster ids (diagnostics and
        engine parity with the reference's explicit probe step)."""
        queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
        qn = cosine.l2_normalize(queries)
        sims = jnp.dot(qn, self.centroids_n.T, preferred_element_type=jnp.float32)
        s, i = jax.lax.top_k(sims, min(nprobe, self.k_clusters))
        return np.asarray(s), np.asarray(i)

    # ---- mutation ----

    def assign(self, new: PackedVectors) -> np.ndarray:
        """Nearest-centroid cluster index for each new row."""
        host = PackedVectors(*[np.asarray(a) for a in new])
        _, cid = cosine.nearest_centroid(
            PackedVectors(*[jnp.asarray(a) for a in host]), self.centroids_n
        )
        return np.asarray(cid, np.int64)

    def insert(
        self, new: PackedVectors, ids: np.ndarray, cids: np.ndarray | None = None
    ) -> "IVFIndex":
        """Append-without-rebuild: assign to nearest centroid, scatter into
        buckets; rows that don't fit spill to the flat tail. `cids` lets the
        caller supply a precomputed assignment (the engine persists the same
        assignment to SQL)."""
        m = int(np.shape(new.codes)[0])
        if m == 0:
            return self
        ids = np.asarray(ids, np.int64)
        new_host = PackedVectors(*[np.asarray(a) for a in new])
        if self.frozen:
            # no functional bucket update possible at this scale (see the
            # frozen field); the spill tail is scanned alongside
            spill = self.spill.append(new_host, ids)
            return replace(self, spill=spill)
        cid = self.assign(new_host) if cids is None else np.asarray(cids, np.int64)

        # Host slot allocation: sequential slots per cluster, duplicates get
        # consecutive positions (vectorized grouped cumcount — no per-row
        # Python loop, so bulk inserts cost O(m log m) not O(m) interpreter
        # iterations).
        counts = self.counts.copy().astype(np.int64)
        order = np.argsort(cid, kind="stable")
        sorted_cid = cid[order]
        run_start = np.flatnonzero(
            np.r_[True, sorted_cid[1:] != sorted_cid[:-1]]
        )
        run_len = np.diff(np.r_[run_start, m])
        within = np.arange(m, dtype=np.int64) - np.repeat(run_start, run_len)
        slot = np.empty(m, np.int64)
        slot[order] = counts[sorted_cid] + within
        counts[sorted_cid[run_start]] += run_len
        fits = slot < self.cap

        idx = self
        if fits.any():
            sel = np.nonzero(fits)[0]
            # pad the scatter batch to a size class; padded entries use an
            # out-of-bounds slot so the scatter drops them.
            m_pad = round_capacity(len(sel))
            pad = m_pad - len(sel)
            cid_p = np.pad(cid[sel], (0, pad))
            slot_p = np.pad(slot[sel], (0, pad), constant_values=self.cap)
            rows = PackedVectors(
                codes=jnp.asarray(np.pad(new_host.codes[sel], ((0, pad), (0, 0)))),
                scale=jnp.asarray(np.pad(new_host.scale[sel], (0, pad))),
                offset=jnp.asarray(np.pad(new_host.offset[sel], (0, pad))),
                inv_norm=jnp.asarray(np.pad(new_host.inv_norm[sel], (0, pad))),
            )
            buckets, bucket_mask = _scatter_rows(
                self.buckets,
                self.bucket_mask,
                jnp.asarray(cid_p, jnp.int32),
                jnp.asarray(slot_p, jnp.int32),
                rows,
            )
            new_counts = np.minimum(counts, self.cap).astype(np.int32)
            id_grid = self.ids.copy()
            id_grid[cid[sel], slot[sel]] = ids[sel]
            mask_host = self.mask_host.copy()
            mask_host[cid[sel], slot[sel]] = True
            idx = replace(
                self,
                buckets=buckets,
                bucket_mask=bucket_mask,
                mask_host=mask_host,
                counts=new_counts,
                counts_dev=jnp.asarray(new_counts),
                ids=id_grid,
                live_count=self.live_count + len(sel),
            )

        if (~fits).any():
            sel = np.nonzero(~fits)[0]
            spill = idx.spill.append(
                PackedVectors(*[np.asarray(a)[sel] for a in new_host]), ids[sel]
            )
            idx = replace(idx, spill=spill)
        return idx

    def remove_ids(self, remove: np.ndarray) -> "IVFIndex":
        """Tombstone rows by external id. Zero D2H: the hit set comes from
        the host mask mirror; only the hit (cluster, slot) coordinates are
        scattered False on device (padded to a pow2 class, pad entries use
        out-of-bounds slots which XLA scatter drops)."""
        remove = np.asarray(remove, np.int64)
        if remove.size == 0:
            return self
        hit = np.isin(self.ids, remove) & self.mask_host
        idx = self
        if hit.any():
            mask_host = self.mask_host.copy()
            mask_host[hit] = False
            cid, slot = np.nonzero(hit)
            m_pad = _coord_class(len(cid))
            pad = m_pad - len(cid)
            cid_p = np.pad(cid, (0, pad))
            slot_p = np.pad(slot, (0, pad), constant_values=self.cap)
            idx = replace(
                idx,
                bucket_mask=_clear_bucket_slots(
                    self.bucket_mask,
                    jnp.asarray(cid_p, jnp.int32),
                    jnp.asarray(slot_p, jnp.int32),
                ),
                mask_host=mask_host,
                live_count=self.live_count - int(hit.sum()),
            )
        spill = idx.spill.remove_ids(remove)
        if spill is not idx.spill:
            idx = replace(idx, spill=spill)
        return idx

    # ---- maintenance ----

    def live_ids(self) -> np.ndarray:
        """External ids of every live row (buckets + spill), host-side."""
        out = self.ids[self.mask_host]
        if self.spill.live > 0:
            smask = self.spill.mask_host[: self.spill.n]
            out = np.concatenate([out, self.spill.ids[: self.spill.n][smask]])
        return out

    def extract_rows(self, wanted: np.ndarray) -> tuple[PackedVectors, np.ndarray]:
        """Host-side gather of the live rows whose external id is in
        `wanted` (order not preserved). Used by the rebuild swap to pick up
        rows inserted while a build was running."""
        wanted = np.asarray(wanted, np.int64)
        hit = np.isin(self.ids, wanted) & self.mask_host
        cid, slot = np.nonzero(hit)
        m = len(cid)
        # gather ON DEVICE, transfer only the [m, D] result — a host-side
        # fancy index would first device_get the whole bucket store.
        # Coordinates are padded to the pow2 coord class (same as
        # remove_ids): m differs on nearly every rebuild reconciliation,
        # and an unpadded gather would compile fresh programs per novel m
        # while refresh holds state.lock.
        m_pad = _coord_class(m)
        dcid = jnp.asarray(np.pad(cid, (0, m_pad - m)), jnp.int32)
        dslot = jnp.asarray(np.pad(slot, (0, m_pad - m)), jnp.int32)
        packed = PackedVectors(
            codes=np.asarray(self.buckets.codes[dcid, dslot])[:m],
            scale=np.asarray(self.buckets.scale[dcid, dslot])[:m],
            offset=np.asarray(self.buckets.offset[dcid, dslot])[:m],
            inv_norm=np.asarray(self.buckets.inv_norm[dcid, dslot])[:m],
        )
        ids = self.ids[cid, slot]
        if self.spill.live > 0:
            smask = self.spill.mask_host[: self.spill.n]
            shit = smask & np.isin(self.spill.ids[: self.spill.n], wanted)
            keep = np.nonzero(shit)[0]
            if keep.size:
                packed = PackedVectors(
                    codes=np.concatenate(
                        [packed.codes, np.asarray(self.spill.packed.codes)[keep]]
                    ),
                    scale=np.concatenate(
                        [packed.scale, np.asarray(self.spill.packed.scale)[keep]]
                    ),
                    offset=np.concatenate(
                        [packed.offset, np.asarray(self.spill.packed.offset)[keep]]
                    ),
                    inv_norm=np.concatenate(
                        [packed.inv_norm, np.asarray(self.spill.packed.inv_norm)[keep]]
                    ),
                )
                ids = np.concatenate([ids, self.spill.ids[keep]])
        return packed, ids

    def export_live(self) -> tuple[PackedVectors, np.ndarray]:
        """All live rows (buckets + spill) as host arrays, for rebuilds."""
        packed, ids, _ = self.export_live_assigned(assign_spill=False)
        return packed, ids

    def export_live_assigned(
        self, assign_spill: bool = True
    ) -> tuple[PackedVectors, np.ndarray, np.ndarray | None]:
        """Live rows plus their cluster assignment, WITHOUT a device pass:
        bucket membership IS the assignment (inserts scatter each row into
        its assigned bucket and the SQL centroid_id row matches). Spill
        rows have no bucket; with assign_spill they get a device
        nearest-centroid pass (small — spill is bounded by compaction),
        otherwise assignments is returned as None when spill rows exist.
        Used by the snapshot path: re-assigning the whole corpus would be a
        full extra device pass per snapshot.

        The device read is CHUNKED by cluster ranges (~256 MB slices via
        ONE jitted dynamic-slice program), so the host never holds a
        second full copy of the bucket store in one transfer buffer."""
        cid, slot = np.nonzero(self.mask_host)
        kk, cap, d = self.buckets.codes.shape
        # cluster-range chunks of ~256 MB of codes each
        step = min(kk, max(1, (256 << 20) // max(1, cap * d)))
        parts = {"codes": [], "scale": [], "offset": [], "inv_norm": []}
        for c0 in range(0, kk, step):
            c1 = min(c0 + step, kk)
            # dynamic_slice clamps: the tail chunk starts at kk-step and
            # overlaps the previous one; local indices are vs actual start
            s = min(c0, kk - step)
            sel = (cid >= c0) & (cid < c1)
            lcid, lslot = cid[sel] - s, slot[sel]
            for name in parts:
                block = np.asarray(
                    _slice_clusters(getattr(self.buckets, name), s, step)
                )
                parts[name].append(block[lcid, lslot])
        packed = PackedVectors(
            codes=np.concatenate(parts["codes"]),
            scale=np.concatenate(parts["scale"]),
            offset=np.concatenate(parts["offset"]),
            inv_norm=np.concatenate(parts["inv_norm"]),
        )
        ids = self.ids[cid, slot]
        assignments: np.ndarray | None = cid.astype(np.int32)
        if self.spill.live > 0:
            smask = self.spill.mask_host[: self.spill.n]
            keep = np.nonzero(smask)[0]
            packed = PackedVectors(
                codes=np.concatenate(
                    [packed.codes, np.asarray(self.spill.packed.codes)[keep]]
                ),
                scale=np.concatenate(
                    [packed.scale, np.asarray(self.spill.packed.scale)[keep]]
                ),
                offset=np.concatenate(
                    [packed.offset, np.asarray(self.spill.packed.offset)[keep]]
                ),
                inv_norm=np.concatenate(
                    [packed.inv_norm, np.asarray(self.spill.packed.inv_norm)[keep]]
                ),
            )
            ids = np.concatenate([ids, self.spill.ids[keep]])
            if keep.size:
                if assign_spill:
                    spill_rows = PackedVectors(
                        *[np.asarray(a)[keep] for a in self.spill.packed]
                    )
                    spill_cid = assign_clusters(
                        spill_rows, np.asarray(self.centroids)
                    )
                    assignments = np.concatenate([assignments, spill_cid])
                else:
                    assignments = None
        return packed, ids, assignments

    def host_assignments(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, cluster assignment) for every live row, from the HOST
        mirrors — no bucket-store device read. Bucket membership IS the
        assignment; only spill rows (small, bounded by compaction) pay a
        nearest-centroid device pass."""
        cid, slot = np.nonzero(self.mask_host)
        ids = self.ids[cid, slot]
        assignments = cid.astype(np.int32)
        if self.spill.live > 0:
            smask = self.spill.mask_host[: self.spill.n]
            keep = np.nonzero(smask)[0]
            if keep.size:
                spill_rows = PackedVectors(
                    *[np.asarray(a)[keep] for a in self.spill.packed]
                )
                spill_cid = assign_clusters(
                    spill_rows, np.asarray(self.centroids)
                )
                ids = np.concatenate([ids, self.spill.ids[keep]])
                assignments = np.concatenate(
                    [assignments, spill_cid.astype(np.int32)]
                )
        return ids, assignments

    @property
    def hbm_bytes(self) -> int:
        """Device footprint: packed buckets (codes + sidecars + mask) PLUS
        the spill tail — which is exactly the part that grows without
        bound on a frozen index, so excluding it would let the HBM budget
        under-count the category (review r3 finding #2)."""
        kk, cap, d = self.buckets.codes.shape
        return kk * cap * (d + 13) + self.spill.hbm_bytes

    def compact(
        self, headroom: float = 1.25, hbm_budget: int | None = None
    ) -> "IVFIndex":
        """Re-pack buckets against the CURRENT centroids (drains spill and
        tombstones without re-running k-means)."""
        packed, ids, assignments = self.export_live_assigned()
        return IVFIndex.build(
            packed, ids, np.asarray(self.centroids),
            assignments=assignments, headroom=headroom, hbm_budget=hbm_budget,
        )

    def release_device(self) -> None:
        """Explicitly free this index's device buffers (bucket store,
        mask, counts, spill tail). Used by the frozen-store sequenced
        re-pack (engine._compact_frozen): the HBM budget cannot hold two
        copies, so the old store must be freed BEFORE the new layout
        uploads. The index is unusable afterwards — the caller must have
        drained every in-flight search first."""
        for arr in (
            *self.buckets, self.bucket_mask, self.counts_dev,
            *self.spill.packed, self.spill.mask,
        ):
            try:
                arr.delete()
            except Exception:  # already deleted / committed elsewhere
                pass


def assign_clusters(
    packed: PackedVectors, centroids: np.ndarray, chunk: int = 65_536
) -> np.ndarray:
    """Nearest-centroid assignment for a host corpus, chunked on device.

    Chunk results stay on device until ONE device_get at the end, so the
    host enqueues every chunk without a synchronous round trip each."""
    cents = cosine.l2_normalize(jnp.asarray(centroids, jnp.float32))
    n = np.shape(packed.codes)[0]
    parts = []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        sub = PackedVectors(*[jnp.asarray(np.asarray(a)[start:end]) for a in packed])
        _, cid = cosine.nearest_centroid(sub, cents)
        parts.append(cid)
    if not parts:
        return np.empty(0, np.int32)
    return np.concatenate([np.asarray(p) for p in jax.device_get(parts)])
