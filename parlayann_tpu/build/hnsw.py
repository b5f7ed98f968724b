"""HNSW builder + layered search.

Reference: HNSW/HNSW.hpp. Multi-level structure: node levels drawn
geometrically (level = floor(-ln(U) * m_l), HNSW.hpp:505-518); level-0
degree cap 2m, upper levels m; insertion descends greedily from the
entrance through upper levels (ef=1), then per level runs an efc-beam
search whose frontier is alpha-occlusion pruned into forward edges
(prune_heuristic, HNSW.hpp:430-503); reverse edges resolve overflow by
sort-truncate-by-distance, NOT alpha-prune (HNSW.hpp:940-988); queries
descend with ef=1 and run the shared beam kernel at level 0
(HNSW.hpp:1089-1109 delegates to beam_search_impl).

Data-parallel mapping: each level is a compact (members, adjacency, gathered
vectors) triple over LOCAL ids; every phase reuses the shared batched beam
kernel and the batched robustPrune. The reference's alpha compare is
``d(c, r) < alpha * d(c, q)`` (HNSW.hpp:462-471, alpha <= 1); robustPrune
implements ``a * d <= d'`` so we pass ``a = 1/alpha``. Levels are assigned
up-front (the whole dataset is known), insertion still runs in
prefix-doubling batches (HNSW.hpp:777-800); the entrance is a LIST of
points at the current max level (HNSW.hpp:130, update rule :991-1007:
replace on a strictly-higher level, append on a tie) and every descent
seeds from all of them.

Model persistence: two formats, auto-detected by magic on load —
  * "HTPU" v2 (ours): params + per-level member lists and fixed-width
    adjacency; loads with zero per-node parsing.
  * "HNSW" v3 (reference-compatible): the byte layout of HNSW.hpp's
    save (:1615-1691) / load (:631-744) — magic, version, two ignored
    size_t type codes, params (dim, m_l, m, efc, alpha, n), an (level,
    point-id) node table, per-node per-level varint-free adjacency
    records (u64 count + u32 node ids), and the entrance list. Models
    are exchangeable with the reference implementation in both
    directions.
"""

from __future__ import annotations

import dataclasses
import os as _os
import struct
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import BuildParams, Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.data.graph import GraphIndexData
from parlayann_tpu.data.pointset import pad_to
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.search.beam import beam_search_batch, top_k_from_beam
from parlayann_tpu.build.prune import robust_prune_chunked
from parlayann_tpu.build.reverse import exchange_reverse_edges
from parlayann_tpu.utils.arrays import as_device


@dataclasses.dataclass
class Level:
    members: np.ndarray  # (ml,) global ids, ascending
    glob2loc: np.ndarray  # (n,) int32, -1 if absent
    points_l: jax.Array  # (ml_pad, d) gathered vectors
    nbrs: jax.Array  # (ml_pad, cap) LOCAL ids
    degs: jax.Array  # (ml_pad,)
    cap: int
    # device twins of the id maps: the build loop and the fused search
    # descent stay device-resident (no per-level host readbacks)
    members_d: jax.Array = None  # (ml_pad,) global ids
    glob2loc_d: jax.Array = None  # (n,)


@dataclasses.dataclass
class HNSWIndex:
    points: PointSet
    levels: list  # Level, index = level number (0 = base)
    entrances: np.ndarray  # (S,) int32 global ids, all at max_level
    m: int
    efc: int
    alpha: float
    m_l: float

    _bidx: Optional[object] = None  # lazy base-graph Index (q8 tier)

    @property
    def max_level(self) -> int:
        return len(self.levels) - 1

    @property
    def entrance(self) -> int:
        return int(self.entrances[0])

    # ---------------- search (HNSW.hpp:1570-1613) ----------------
    def _base_index(self):
        """Lazy Index over the level-0 graph: the beam runs on the q8
        tier and a rerank restores precision. When level 1 is small
        enough for one dense scan, its members become the Index ENTRY
        TIER, so the hierarchy's entry computation is the same exact
        top-1 the Vamana path runs (a strictly better entry than the
        greedy upper-level walk, HNSW.hpp:1532-1567)."""
        if self._bidx is None:
            from parlayann_tpu.index import Index

            self._bidx = Index(
                points=self.points, graph=self.base_graph()
            ).enable_quantized(bits=8)
            if self.max_level > 0 and self._entry_foldable():
                mem = self.levels[1].members.astype(np.int32)
                self._bidx.entry_ids = jnp.asarray(mem)
                self._bidx.entry_vecs = jnp.take(
                    self.points.data, self._bidx.entry_ids, axis=0
                )
                self._bidx.entry_min_n = 0
        return self._bidx

    def _entry_foldable(self) -> bool:
        return (self.max_level > 0
                and len(self.levels[1].members) <= 512 * 1024)

    def batch_search(self, queries, k: int = 10, ef: int = 64,
                     cut: float = 1.35, expand: int = 1):
        q = as_device(queries)
        B = q.shape[0]
        # greedy descent ef=1 through upper levels (search_layer_to,
        # HNSW.hpp:1532-1567) seeded from the FULL entrance list — ONE
        # jitted program over all upper levels (their arrays are tiny and
        # stay on device)
        L = max(ef, k)
        if expand == 1 and self._entry_foldable():
            # entry tier = level-1 members (see _base_index): the same
            # route as the Vamana search
            ids, dists, _ = self._base_index().batch_search(
                q, k=k, beam_size=L, cut=cut,
            )
            return ids, dists
        S = 1
        while S < len(self.entrances):
            S *= 2
        ent_pad = np.full(S, -1, dtype=np.int32)
        ent_pad[: len(self.entrances)] = self.entrances
        entry = jnp.asarray(np.broadcast_to(ent_pad, (B, S)))
        if self.max_level > 0:
            lv1 = self.levels[1]
            if len(lv1.members) <= 512 * 1024:
                # exact 1-NN over level-1 members by matmul — strictly
                # better entries than the greedy walk, at dense-matmul cost
                entry = _entry_top1(
                    q, lv1.points_l, lv1.members_d,
                    metric=self.points.metric, nv=len(lv1.members),
                )
            else:
                upper = self.levels[:0:-1]  # top .. 1
                largs = tuple(
                    (lv.points_l, lv.nbrs, lv.degs, lv.members_d,
                     lv.glob2loc_d)
                    for lv in upper
                )
                nvs = tuple(len(lv.members) for lv in upper)
                entry = _descent_all(
                    q, largs, entry, metric=self.points.metric, nvs=nvs
                )
        else:
            entry = jnp.where(entry[:, 0] >= 0, entry[:, 0], 0)

        # level 0: route through Index.batch_search with per-query starts
        # — the same single-program search the Vamana path runs
        # (translate + beam + straggler compaction + rerank,
        # search/fused.py)
        idx = self._base_index()
        if expand == 1:
            ids, dists, _ = idx.batch_search(
                q, k=k, beam_size=L, cut=cut, starts=entry,
            )
            return ids, dists
        lv0 = self.levels[0]
        res = beam_search_batch(
            q, lv0.points_l, lv0.nbrs, lv0.degs, entry[:, None],
            metric=self.points.metric, n_valid=self.points.n,
            k=k, L=L, cut=cut, expand=expand,
        )
        return top_k_from_beam(res, k)

    def batch_search_timed(self, queries, k: int = 10, ef: int = 64,
                           cut: float = 1.35, warmup: bool = True,
                           rounds: int = 1):
        """Timed search (R back-to-back dispatches + one fence,
        Index.batch_search_timed semantics) -> (ids, dists, res,
        seconds-per-round). Requires the foldable-entry regime (level 1
        small enough for one dense scan)."""
        if not self._entry_foldable():
            raise ValueError("timed path requires a foldable level-1 entry")
        return self._base_index().batch_search_timed(
            queries, warmup=warmup, rounds=rounds,
            k=k, beam_size=max(ef, k), cut=cut,
        )

    def base_graph(self) -> GraphIndexData:
        """The level-0 graph as a standard GraphIndexData (level-0 local ids
        are global ids)."""
        lv0 = self.levels[0]
        return GraphIndexData(
            neighbors=lv0.nbrs, degrees=lv0.degs, n=self.points.n,
            max_degree=lv0.cap,
        )

    # ---------------- persistence ----------------
    def level_of(self) -> np.ndarray:
        """(n,) max level of every point."""
        out = np.zeros(self.points.n, dtype=np.int32)
        for l in range(1, len(self.levels)):
            out[self.levels[l].members] = l
        return out

    def save(self, path: str) -> None:
        """Fast fixed-width format ("HTPU" v2: entrance list)."""
        with open(path, "wb") as f:
            f.write(b"HTPU")
            f.write(struct.pack("<iiiff", 2, self.points.n, self.m,
                                self.alpha, self.m_l))
            f.write(struct.pack("<iii", self.efc, len(self.levels),
                                len(self.entrances)))
            self.entrances.astype(np.int32).tofile(f)
            for l, lv in enumerate(self.levels):
                nb = np.asarray(lv.nbrs)[: len(lv.members)]
                dg = np.asarray(lv.degs)[: len(lv.members)]
                f.write(struct.pack("<iii", len(lv.members), lv.cap, 0))
                lv.members.astype(np.int32).tofile(f)
                dg.astype(np.int32).tofile(f)
                nb.astype(np.int32).tofile(f)

    @staticmethod
    def load(path: str, points: PointSet) -> "HNSWIndex":
        """Auto-detects "HTPU" (v1/v2) vs the reference "HNSW" v3 magic."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == b"HNSW":
            return HNSWIndex.load_v3(path, points)
        assert magic == b"HTPU", "bad HNSW model file"
        with open(path, "rb") as f:
            f.read(4)
            ver = struct.unpack("<i", f.read(4))[0]
            if ver == 1:
                n, m, alpha, m_l, ent0 = struct.unpack("<iiffi", f.read(20))
                efc, n_levels = struct.unpack("<ii", f.read(8))
                entrances = np.asarray([ent0], dtype=np.int32)
            else:
                n, m, alpha, m_l = struct.unpack("<iiff", f.read(16))
                efc, n_levels, n_ent = struct.unpack("<iii", f.read(12))
                entrances = np.fromfile(f, np.int32, n_ent)
            levels = []
            for l in range(n_levels):
                ml, cap, _ = struct.unpack("<iii", f.read(12))
                members = np.fromfile(f, np.int32, ml)
                dg = np.fromfile(f, np.int32, ml)
                nb = np.fromfile(f, np.int32, ml * cap).reshape(ml, cap)
                levels.append(
                    _make_level(points, members, cap, nbrs=nb, degs=dg)
                )
        return HNSWIndex(points=points, levels=levels, entrances=entrances,
                         m=m, efc=efc, alpha=alpha, m_l=m_l)

    def save_v3(self, path: str) -> None:
        """Write the reference's versioned binary model (magic "HNSW",
        version 3 — byte layout of HNSW.hpp:1615-1691) so models built here
        load in the reference implementation. Node ids are point ids (the
        reference permits any node order; the (level, id) table carries the
        mapping). Neighbor lists are global point ids mapped back from our
        per-level local ids."""
        n = self.points.n
        lev = self.level_of()
        degs_l, glob_l = [], []
        for lv in self.levels:
            ml = len(lv.members)
            degs_l.append(np.asarray(lv.degs)[:ml].astype(np.int64))
            nb = np.asarray(lv.nbrs)[:ml]
            glob_l.append(lv.members[np.clip(nb, 0, ml - 1)].astype(np.uint32))

        # per-node record block: for l in 0..lev[u]: u64 count + u32 ids
        node_len = np.zeros(n, dtype=np.int64)  # record bytes per node
        for l, lv in enumerate(self.levels):
            node_len[lv.members] += 8 + 4 * degs_l[l]
        node_off = np.concatenate([[0], np.cumsum(node_len)])
        buf = np.zeros(int(node_off[-1]), dtype=np.uint8)
        within = np.zeros(n, dtype=np.int64)  # offset of level l's record
        for l, lv in enumerate(self.levels):
            mem = lv.members
            start = node_off[mem] + within[mem]
            # u64 size field
            szb = degs_l[l].astype("<u8").view(np.uint8).reshape(-1, 8)
            fidx = (start[:, None] + np.arange(8)).ravel()
            buf[fidx] = szb.ravel()
            # u32 ids (jagged): flatten valid slots
            d = degs_l[l]
            rows = np.repeat(np.arange(len(mem)), d)
            cols = np.concatenate([np.arange(x) for x in d]) if len(d) else \
                np.zeros(0, np.int64)
            ids = glob_l[l][rows, cols].astype("<u4")
            tgt = np.repeat(start + 8, d) + 4 * cols
            bidx = (tgt[:, None] + np.arange(4)).ravel()
            buf[bidx] = ids.view(np.uint8).reshape(-1, 4).ravel()
            within[mem] += 8 + 4 * d

        with open(path, "wb") as f:
            f.write(b"HNSW")
            f.write(struct.pack("<I", 3))
            f.write(struct.pack("<QQ", 0, 0))  # code_U, sizeof(node): the
            # reference loader reads and ignores both (HNSW.hpp:684-688)
            f.write(struct.pack("<IfIIfI", self.points.d, self.m_l, self.m,
                                self.efc, self.alpha, n))
            table = np.empty((n, 2), dtype="<u4")
            table[:, 0] = lev.astype(np.uint32)
            table[:, 1] = np.arange(n, dtype=np.uint32)  # point id == node id
            table.tofile(f)
            buf.tofile(f)
            f.write(struct.pack("<Q", len(self.entrances)))
            self.entrances.astype("<u4").tofile(f)

    @staticmethod
    def load_v3(path: str, points: PointSet) -> "HNSWIndex":
        """Read a reference "HNSW" v3 model (HNSW.hpp:631-744), including
        ones written by the reference implementation (arbitrary node order,
        neighbor lists in node ids)."""
        with open(path, "rb") as f:
            raw = f.read()
        assert raw[:4] == b"HNSW", "bad v3 model"
        (version,) = struct.unpack_from("<I", raw, 4)
        assert version == 3, f"unsupported HNSW model version {version}"
        off = 8 + 16  # skip code_U + sizeof(node)
        dim, m_l, m, efc, alpha, n = struct.unpack_from("<IfIIfI", raw, off)
        off += 24
        table = np.frombuffer(raw, dtype="<u4", count=2 * n, offset=off)
        off += 8 * n
        node_lev = table[0::2].astype(np.int32)
        node_pid = table[1::2].astype(np.int32)  # node id -> point id
        max_level = int(node_lev.max()) if n else 0

        # walk the jagged per-node records
        nbrs_nodeids = [[] for _ in range(max_level + 1)]  # per level: (node, ids)
        mv = memoryview(raw)
        for u in range(n):
            for l in range(int(node_lev[u]) + 1):
                (cnt,) = struct.unpack_from("<Q", mv, off)
                off += 8
                ids = np.frombuffer(raw, dtype="<u4", count=cnt, offset=off)
                off += 4 * int(cnt)
                nbrs_nodeids[l].append((u, ids))
        (n_ent,) = struct.unpack_from("<Q", mv, off)
        off += 8
        ent_nodes = np.frombuffer(raw, dtype="<u4", count=n_ent, offset=off)
        entrances = node_pid[ent_nodes.astype(np.int64)].astype(np.int32)

        levels = []
        for l in range(max_level + 1):
            members = np.sort(node_pid[node_lev >= l]).astype(np.int32)
            g2l = np.full(points.n, -1, dtype=np.int32)
            g2l[members] = np.arange(len(members), dtype=np.int32)
            cap_ref = 2 * m if l == 0 else m
            cap = max(cap_ref,
                      max((len(i) for _, i in nbrs_nodeids[l]), default=0))
            nb = np.full((len(members), cap), -1, dtype=np.int32)
            dg = np.zeros(len(members), dtype=np.int32)
            for u, ids in nbrs_nodeids[l]:
                loc = g2l[node_pid[u]]
                pid_nbrs = node_pid[ids.astype(np.int64)]
                nb[loc, : len(ids)] = g2l[pid_nbrs]
                dg[loc] = len(ids)
            levels.append(_make_level(points, members, cap, nbrs=nb, degs=dg))
        return HNSWIndex(points=points, levels=levels, entrances=entrances,
                         m=int(m), efc=int(efc), alpha=float(alpha),
                         m_l=float(m_l))


def _make_level(points: PointSet, members: np.ndarray, cap: int,
                nbrs=None, degs=None) -> Level:
    n = points.n
    ml = len(members)
    ml_pad = pad_to(max(ml, 1), 8)
    glob2loc = np.full(n, -1, dtype=np.int32)
    glob2loc[members] = np.arange(ml, dtype=np.int32)
    pts = jnp.take(
        points.data, jnp.asarray(np.pad(members, (0, ml_pad - ml))), axis=0
    )
    if nbrs is None:
        nbrs_a = jnp.zeros((ml_pad, cap), jnp.int32)
        degs_a = jnp.zeros((ml_pad,), jnp.int32)
    else:
        nbrs_a = jnp.asarray(
            np.pad(nbrs, ((0, ml_pad - ml), (0, 0))).astype(np.int32)
        )
        degs_a = jnp.asarray(np.pad(degs, (0, ml_pad - ml)).astype(np.int32))
    return Level(members=members, glob2loc=glob2loc, points_l=pts,
                 nbrs=nbrs_a, degs=degs_a, cap=cap,
                 members_d=jnp.asarray(np.pad(members, (0, ml_pad - ml))),
                 glob2loc_d=jnp.asarray(glob2loc))


def assign_levels(n: int, m_l: float, rng: np.random.Generator) -> np.ndarray:
    """Geometric level per point (get_level_random, HNSW.hpp:505-518)."""
    u = rng.random(n)
    lev = np.floor(-np.log(np.maximum(u, 1e-12)) * m_l).astype(np.int32)
    return np.minimum(lev, 24)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("metric", "nv", "chunk"))
def _entry_top1(q, pts_l, members_d, *, metric: Metric, nv: int,
                chunk: int = 8192):
    """EXACT nearest level-1 member per query, via tiled matmuls — the
    replacement for the greedy upper-level descent (HNSW.hpp:1532-1567).
    The descent's only job is to pick a good level-0 entry; level 1
    holds ~n*exp(-1/m_l) (~5%) of the points, so one dense top-1 over
    its members returns a strictly better entry than any graph walk
    approximating it. Default matmul precision (TF32 on tensor cores):
    this only picks a start vertex; returned distances are exact."""
    B, d = q.shape
    qf = q.astype(jnp.float32)
    ml_pad = pts_l.shape[0]
    nch = -(-ml_pad // chunk)
    pad = nch * chunk - ml_pad

    def one(carry, io):
        best_d, best_i = carry
        off = io * chunk
        blk = jax.lax.dynamic_slice_in_dim(pts_l, off, chunk, 0).astype(
            jnp.float32
        )
        dot = jnp.dot(qf, blk.T, preferred_element_type=jnp.float32)
        lid = off + jnp.arange(chunk, dtype=jnp.int32)
        if metric is Metric.MIPS:
            dist = -dot
        else:
            dist = jnp.sum(blk * blk, axis=1)[None, :] - 2.0 * dot
        dist = jnp.where((lid < nv)[None, :], dist, INF)
        cd = jnp.min(dist, axis=1)
        ci = off + jnp.argmin(dist, axis=1).astype(jnp.int32)
        upd = cd < best_d
        return (jnp.where(upd, cd, best_d), jnp.where(upd, ci, best_i)), None

    if pad:
        pts_l = jnp.pad(pts_l, ((0, pad), (0, 0)))
    (best_d, best_i), _ = jax.lax.scan(
        one, (jnp.full((B,), INF), jnp.zeros((B,), jnp.int32)),
        jnp.arange(nch, dtype=jnp.int32),
    )
    return members_d[jnp.clip(best_i, 0, members_d.shape[0] - 1)]


@_partial(jax.jit, static_argnames=("metric", "nvs"))
def _descent_all(q, levels_args, entry, *, metric: Metric, nvs):
    """Greedy ef=1 descent through ALL upper levels in one program
    (HNSW.hpp:1532-1567). ``levels_args``: per level top..1, a tuple
    (points_l, nbrs, degs, members_d, glob2loc_d); ``nvs``: their member
    counts (static). Returns (B,) global level-1 exits."""
    for (pts, nb, dg, mem, g2l), nv in zip(levels_args, nvs):
        starts = jnp.where(
            entry >= 0, g2l[jnp.clip(entry, 0, None)], -1
        )
        res = beam_search_batch(
            q, pts, nb, dg, starts, metric=metric, n_valid=nv, k=0, L=1,
        )
        loc = res.beam_ids[:, 0]
        entry = jnp.where(
            loc >= 0, mem[jnp.clip(loc, 0, None)], entry[:, 0]
        )[:, None]
    return entry[:, 0]


@_partial(jax.jit,
          static_argnames=("n_valid", "efc", "m_fwd", "metric", "expand"),
          donate_argnums=(1, 2))
def _insert_at_level_dev(
    lv_points, lv_nbrs, lv_degs, lv_members_d, lv_glob2loc_d,
    points_data, batch_glob, entry_glob, ins_mask, alpha_arr,
    vmask=None,
    *, n_valid: int, efc: int, m_fwd: int, metric: Metric,
    expand: int = 1,
):
    """Device-resident batch insert into one level (insert + set_neighbourhood
    + reverse, HNSW.hpp:869-1014). ``ins_mask`` masks which batch rows insert
    at this level (rows with False are untouched and pass their entry
    through) — the whole batch goes through one fixed-shape program, so the
    host never slices or reads anything back between levels.

    Returns (nbrs, degs, entry_next (B,) global ids)."""
    cap = lv_nbrs.shape[1]
    bg = jnp.where(ins_mask, batch_glob, -1)
    loc = jnp.where(
        bg >= 0, lv_glob2loc_d[jnp.clip(bg, 0, None)], -1
    ).astype(jnp.int32)
    # -1 padding in the entrance list stays -1 locally (invalid start)
    eg = entry_glob
    starts = jnp.where(eg >= 0, lv_glob2loc_d[jnp.clip(eg, 0, None)], -1)
    q = jnp.take(points_data, jnp.clip(batch_glob, 0, None), axis=0)

    if n_valid <= 8192:
        # small level: the efc-beam needs ~efc SEQUENTIAL steps no
        # matter how small the level is (step-count-bound — measured
        # ~30% of the 100K build in diag_hnsw_build), while one flat
        # matmul scan returns the EXACT top-efc candidate set (a strict
        # quality upgrade over the graph walk the reference runs,
        # HNSW.hpp:869-881; select_neighbors semantics unchanged)
        from parlayann_tpu.search.flat import flat_search_batch

        # scan ONLY already-inserted members (``vmask``): the beam path
        # can reach only wired vertices, and an exact hit on a future
        # (degree-0) member would flow down the entry chain and seed the
        # next level's beam at a dead vertex — measured recall collapse
        # .88 -> .16 at 12K before this mask
        kf = min(efc, n_valid)
        cand_ids, cand_d = flat_search_batch(
            q.astype(jnp.float32), lv_points, vmask, exclude_ids=loc,
            k=kf, metric=metric, n_valid=n_valid,
            chunk=min(lv_points.shape[0], 8192),
        )
        if kf < efc:  # keep the efc candidate width the prune expects
            cand_ids = jnp.pad(cand_ids, ((0, 0), (0, efc - kf)),
                               constant_values=-1)
            cand_d = jnp.pad(cand_d, ((0, 0), (0, efc - kf)),
                             constant_values=INF)
        beam_ids = jnp.where(cand_d < INF, cand_ids, -1)
        beam_dists = cand_d
    else:
        # ``expand`` > 1 amortizes the ~efc sequential single-expansion
        # steps (the same batched-expansion economics as the Vamana
        # build's PARLAYANN_BUILD_EXPAND)
        res = beam_search_batch(
            q, lv_points, lv_nbrs, lv_degs, starts, loc,
            metric=metric, n_valid=n_valid, k=0, L=efc,
            exclude_self=True, expand=expand,
        )
        beam_ids, beam_dists = res.beam_ids, res.beam_dists
    # forward edges: alpha-prune the efc frontier (select_neighbors)
    pr = robust_prune_chunked(
        loc, beam_ids,
        jnp.where(beam_ids >= 0, beam_dists, INF),
        lv_points, alpha_arr, R=m_fwd, metric=metric,
        n_valid=n_valid,
    )
    wt = jnp.where(loc >= 0, loc, lv_nbrs.shape[0])
    if m_fwd < cap:
        sel = jnp.pad(pr.ids, ((0, 0), (0, cap - m_fwd)), constant_values=-1)
        seld = jnp.pad(pr.dists, ((0, 0), (0, cap - m_fwd)),
                       constant_values=INF)
    else:
        sel, seld = pr.ids, pr.dists
    nbrs = lv_nbrs.at[wt].set(sel, mode="drop")
    degs = lv_degs.at[wt].set(pr.degree, mode="drop")
    # reverse edges: overflow -> sort-truncate (HNSW.hpp:940-988)
    nbrs, degs, _ = exchange_reverse_edges(
        nbrs, degs, loc, sel, seld, lv_points,
        alpha_arr, R=cap, metric=metric,
        n_valid=n_valid, prune_budget=-1,
    )
    closest = beam_ids[:, 0]
    entry_next = jnp.where(
        ins_mask & (closest >= 0),
        lv_members_d[jnp.clip(closest, 0, None)], entry_glob[:, 0],
    )
    return nbrs, degs, entry_next


@_partial(jax.jit, static_argnames=("n_valid", "metric"))
def _descend_dev(
    lv_points, lv_nbrs, lv_degs, lv_members_d, lv_glob2loc_d,
    points_data, batch_glob, entry_glob, desc_mask,
    *, n_valid: int, metric: Metric,
):
    """Greedy ef=1 step through one level (HNSW.hpp:1532-1567), masked and
    device-resident. Returns entry_next (B,) global ids."""
    eg = entry_glob
    starts = jnp.where(
        (eg >= 0) & desc_mask[:, None],
        lv_glob2loc_d[jnp.clip(eg, 0, None)], -1,
    )
    q = jnp.take(points_data, jnp.clip(batch_glob, 0, None), axis=0)
    res = beam_search_batch(
        q, lv_points, lv_nbrs, lv_degs, starts,
        metric=metric, n_valid=n_valid, k=0, L=1,
    )
    loc = res.beam_ids[:, 0]
    return jnp.where(
        desc_mask & (loc >= 0),
        lv_members_d[jnp.clip(loc, 0, None)], entry_glob[:, 0],
    )


def build_hnsw_graph(points: PointSet, bp: BuildParams,
                     verbose: bool = False, quantize_build: bool = False):
    """Build an HNSW index (ctor + insert, HNSW.hpp:748-1014).

    ``quantize_build``: run every build-time distance (descents, efc
    beams, prunes) on a scalar-quantized int8 tier — 4x smaller gathers,
    the same lever the Vamana builder ships (build_vamana_index). The
    returned index's levels are re-gathered at full precision, so search
    is unaffected except through graph structure."""
    n = points.n
    m = bp.R if bp.R > 0 else 20
    efc = bp.L if bp.L > 0 else 50
    alpha = bp.alpha if bp.alpha > 0 else 0.9
    m_l = bp.m_l if bp.m_l > 0 else 0.34
    a_vam = jnp.float32(1.0 / alpha)
    rng = np.random.default_rng(bp.seed)
    t0 = time.perf_counter()

    build_ps = points
    if quantize_build and points.data.dtype == jnp.float32:
        from parlayann_tpu.ops import quantize

        build_ps = quantize.quantize_pointset(points, bits=8)

    levels_of = assign_levels(n, m_l, rng)
    max_level = int(levels_of.max())
    levels = []
    for l in range(max_level + 1):
        members = np.flatnonzero(levels_of >= l).astype(np.int32)
        cap = 2 * m if l == 0 else m
        levels.append(_make_level(build_ps, members, cap))
    # level 0 membership is everyone in id order: local ids == global ids
    assert np.array_equal(levels[0].members, np.arange(n, dtype=np.int32))

    order = rng.permutation(n).astype(np.int32)
    entrances = [int(order[0])]  # entrance list (HNSW.hpp:130)
    # host-side inserted flags: the exact-scan candidate phase must see
    # only already-wired members (batch-mates excluded, like the beam)
    ins_flag = np.zeros(n, dtype=bool)
    ent_level = int(levels_of[entrances[0]])

    max_batch = min(max(int(bp.batch_cap_frac * n), 1), 1_000_000)
    # prefix-doubling boundaries (HNSW.hpp:777-800)
    bounds = []
    lo = 0
    size = 1
    while lo < n:
        hi = min(lo + size, n)
        bounds.append((lo, hi))
        lo = hi
        size = min(size * 2, max_batch)
    upper_bucket = 256

    for bi, (lo, hi) in enumerate(bounds):
        batch = order[lo:hi]
        blev = levels_of[batch]
        # every descent seeds from the FULL entrance list (HNSW.hpp:869-881);
        # after the first level touched, entry collapses to the single best.
        # The list is padded to a power of two (-1 = invalid, masked by the
        # beam init): a growing width would re-specialize (recompile)
        # every beam program.
        S = 1
        while S < len(entrances):
            S *= 2
        ent_pad = np.full(S, -1, dtype=np.int32)
        ent_pad[: len(entrances)] = entrances
        # pad the batch to a power of two (min upper_bucket): few compile
        # shapes, and the whole batch flows through every level as ONE
        # masked fixed-shape program (no per-level host slicing)
        bw = upper_bucket
        while bw < len(batch):
            bw *= 2
        bg = np.full(bw, -1, dtype=np.int32)
        bg[: len(batch)] = batch
        blev_pad = np.full(bw, -1, dtype=np.int32)
        blev_pad[: len(batch)] = blev
        bg_d = jnp.asarray(bg)
        entry_d = jnp.asarray(np.broadcast_to(ent_pad, (bw, S)).copy())
        # start at the batch's own max level, not just the entrance level —
        # points above the current entrance insert on ALL their levels
        # (HNSW.hpp:991-1007), not only after later reverse edges wire them
        for l in range(max(ent_level, int(blev.max())), -1, -1):
            ins_mask = blev_pad >= l
            # only descend through levels the entrances actually reach
            desc_mask = ~ins_mask & (blev_pad >= 0) & (l <= ent_level)
            lv = levels[l]
            vmask_d = None
            if len(lv.members) <= 8192:  # the exact-scan regime
                vm = np.zeros(lv.points_l.shape[0], dtype=bool)
                vm[: len(lv.members)] = ins_flag[lv.members]
                vmask_d = jnp.asarray(vm)
            if desc_mask.any() and l > 0:
                entry_next = _descend_dev(
                    lv.points_l, lv.nbrs, lv.degs, lv.members_d,
                    lv.glob2loc_d, build_ps.data, bg_d, entry_d,
                    jnp.asarray(desc_mask),
                    n_valid=len(lv.members), metric=points.metric,
                )
                entry_d = jnp.where(
                    jnp.asarray(desc_mask)[:, None], entry_next[:, None],
                    entry_d,
                )
            if ins_mask.any():
                if l > 0 and int(ins_mask.sum()) <= bw // 4:
                    # upper levels insert a geometric fraction of the
                    # batch (~e^{-l/m_l}); running the FULL batch width
                    # through the efc-beam against a few-hundred-node
                    # level was ~30% of total build time at 100K
                    # (diag_hnsw_build). The inserting rows are known on
                    # the HOST (blev is host data), so compact them into
                    # a pow2-bucketed sub-batch — gather in, insert,
                    # scatter the entries back; no device readback.
                    rows = np.flatnonzero(ins_mask).astype(np.int32)
                    sw = upper_bucket
                    while sw < len(rows):
                        sw *= 2
                    # pad rows point at index bw: out of range, so the
                    # scatter-back drops them and the gather clips to a
                    # row the sub_mask already disables
                    rows_pad = np.full(sw, bw, dtype=np.int32)
                    rows_pad[: len(rows)] = rows
                    rd = jnp.asarray(rows_pad)
                    sub_mask = np.zeros(sw, dtype=bool)
                    sub_mask[: len(rows)] = True
                    lv.nbrs, lv.degs, entry_sub = _insert_at_level_dev(
                        lv.points_l, lv.nbrs, lv.degs, lv.members_d,
                        lv.glob2loc_d, build_ps.data,
                        jnp.take(bg_d, rd), jnp.take(entry_d, rd, axis=0),
                        jnp.asarray(sub_mask), a_vam, vmask_d,
                        n_valid=len(lv.members), efc=efc, m_fwd=m,
                        metric=points.metric,
                    )
                    upd = jnp.zeros((bw,), jnp.int32).at[rd].set(
                        jnp.asarray(sub_mask, jnp.int32), mode="drop")
                    ent_new = jnp.zeros((bw,), jnp.int32).at[rd].set(
                        jnp.where(jnp.asarray(sub_mask), entry_sub, 0),
                        mode="drop")
                    entry_d = jnp.where(
                        (upd > 0)[:, None], ent_new[:, None], entry_d)
                else:
                    # level-0 steady batches: multi-expansion (cuts the
                    # ~efc sequential steps ~expand-fold)
                    expv = 1
                    if l == 0 and len(lv.members) > 8192:
                        expv = int(_os.environ.get(
                            "PARLAYANN_HNSW_EXPAND", "4"))
                    lv.nbrs, lv.degs, entry_next = _insert_at_level_dev(
                        lv.points_l, lv.nbrs, lv.degs, lv.members_d,
                        lv.glob2loc_d, build_ps.data, bg_d, entry_d,
                        jnp.asarray(ins_mask), a_vam, vmask_d,
                        n_valid=len(lv.members), efc=efc, m_fwd=m,
                        metric=points.metric, expand=expv,
                    )
                    entry_d = jnp.where(
                        jnp.asarray(ins_mask)[:, None], entry_next[:, None],
                        entry_d,
                    )
        # entrance update (HNSW.hpp:991-1007): replace on a strictly higher
        # level, append the batch's highest node on a tie
        top = int(blev.max())
        highest = int(batch[int(np.argmax(blev))])
        if top > ent_level:
            entrances = [highest]
            ent_level = top
        elif top == ent_level and highest not in entrances:
            entrances.append(highest)
        ins_flag[batch] = True
        if verbose and bi % 8 == 0:
            print(f"hnsw: batch {bi+1}/{len(bounds)}", flush=True)

    if build_ps is not points:
        # search levels hold full-precision vectors (upper-level descent
        # quality); the q8 tier was build-only
        for lv in levels:
            ml, ml_pad = len(lv.members), lv.points_l.shape[0]
            lv.points_l = jnp.take(
                points.data,
                jnp.asarray(np.pad(lv.members, (0, ml_pad - ml))), axis=0,
            )
    idx = HNSWIndex(points=points, levels=levels,
                    entrances=np.asarray(entrances, dtype=np.int32),
                    m=m, efc=efc, alpha=alpha, m_l=m_l)
    _ = int(jnp.sum(levels[0].degs))  # readback fence
    return idx, time.perf_counter() - t0


def build_hnsw_index(
    data,
    metric: Metric = Metric.L2,
    m: int = 20,
    efc: int = 50,
    alpha: float = 0.9,
    m_l: Optional[float] = None,
    verbose: bool = False,
    seed: int = 0,
    quantize_build: bool = False,
):
    """Convenience wrapper (python/builder.cpp:202-237; defaults from
    docs/algorithms.md:77-81)."""
    metric = Metric.coerce(metric)
    ps = data if isinstance(data, PointSet) else PointSet.from_numpy(
        np.asarray(data), metric=metric
    )
    bp = BuildParams(
        R=m, L=efc, alpha=alpha, m_l=m_l if m_l is not None else 0.34,
        seed=seed,
    )
    idx, dt = build_hnsw_graph(ps, bp, verbose=verbose,
                               quantize_build=quantize_build)
    return idx, ps, dt
