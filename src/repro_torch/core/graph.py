"""Graph containers and preprocessing (PyTorch port of ``repro.core.graph``).

The paper (§4.1) preprocesses every graph by sorting each vertex's
incident edges in weight order and quantising the edge-weight
distribution into an ``RtoW[RATIO_NUM]`` lookup table.  Construction is
numpy on the host (:class:`HostGraph`); :meth:`HostGraph.to_device`
moves it into torch tensors (:class:`DeviceGraph`) on one device.

Index tensors that the engine gathers or scatters with are int64 on the
device (torch's index width), widened once here rather than every
round; every other array keeps the reference's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import f32math

RATIO_NUM = 4096          # paper §4.1: RATIO_NUM = 2^12
ST_NUM = 1024             # paper §4.1: ST_NUM = 2^10
DEFAULT_ALPHA = 3         # paper §4.1: alpha = 3
DEFAULT_BETA = 0.9        # paper §4.1: beta = 0.9

# Degree-histogram bucketing used by highD(): exact for deg < EXACT_DEG,
# log2 buckets above.  90 buckets covers degree up to 2^31.
EXACT_DEG = 64
N_DEG_BUCKETS = EXACT_DEG + 26

# blocked-layout geometry defaults (the edge_relax kernel's own)
DEFAULT_BLOCK_V = 512
DEFAULT_TILE_E = 512
# tile width of the layout derived for the CUDA kernel (one thread block
# of 256 threads walks one tile)
CUDA_TILE_E = 256


class DeviceGraph(NamedTuple):
    """Device-resident CSR + flat edge list."""
    src: torch.Tensor       # [M] int64 — source of each directed edge slot
    dst: torch.Tensor       # [M] int64 — destination
    w: torch.Tensor         # [M] float32 — weight (sorted ascending per row)
    row_ptr: torch.Tensor   # [N+1] int64 — CSR offsets into (dst, w)
    deg: torch.Tensor       # [N] int32 — vertex degree (directed slot count)
    rtow: torch.Tensor      # [RATIO_NUM] float32 — weight quantile LUT
    max_w: torch.Tensor     # 0-d float32 — maxW(G, 1)
    n_edges2: torch.Tensor  # 0-d int32 — 2|E| (directed slot count)

    @property
    def n(self) -> int:
        return self.deg.shape[0]

    @property
    def m(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.deg.device


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """numpy-side graph (built on the host; moved to a device once per run)."""
    n: int
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    row_ptr: np.ndarray
    deg: np.ndarray
    rtow: np.ndarray
    max_w: float

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_edges_undirected(self) -> int:
        return self.m // 2

    def to_device(self, device) -> DeviceGraph:
        dev = torch.device(device)

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        return DeviceGraph(
            src=t(self.src, torch.int64), dst=t(self.dst, torch.int64),
            w=t(self.w, torch.float32), row_ptr=t(self.row_ptr, torch.int64),
            deg=t(self.deg, torch.int32), rtow=t(self.rtow, torch.float32),
            max_w=torch.tensor(np.float32(self.max_w), device=dev),
            n_edges2=torch.tensor(self.m, dtype=torch.int32, device=dev))


def _weight_quantile_lut(w: np.ndarray, ratio_num: int = RATIO_NUM) -> np.ndarray:
    """``RtoW[x] = maxW(G, x/(ratio_num-1))`` — P(w(e) <= maxW(G, r)) = r."""
    if w.size == 0:
        return np.zeros((ratio_num,), np.float32)
    qs = np.linspace(0.0, 1.0, ratio_num)
    return np.quantile(w, qs).astype(np.float32)


def build_csr(n: int, eu: np.ndarray, ev: np.ndarray, ew: np.ndarray,
              symmetrize: bool = True) -> HostGraph:
    """Build the preprocessed CSR from an undirected edge list.

    ``(eu[i], ev[i], ew[i])`` is one undirected edge; both directions are
    stored.  Per-vertex adjacency is sorted by weight ascending (paper
    §4.1 preprocessing).
    """
    eu = np.asarray(eu, np.int64)
    ev = np.asarray(ev, np.int64)
    ew = np.asarray(ew, np.float64)
    if symmetrize:
        s = np.concatenate([eu, ev])
        d = np.concatenate([ev, eu])
        w = np.concatenate([ew, ew])
    else:
        s, d, w = eu, ev, ew
    order = np.lexsort((w, s))
    s, d, w = s[order], d[order], w[order]
    deg = np.bincount(s, minlength=n).astype(np.int32)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    # RtoW from the float64 weights: the directed store duplicates every
    # weight, so the quantiles equal the undirected multiset's
    rtow = _weight_quantile_lut(w)
    return HostGraph(
        n=n, src=s.astype(np.int32), dst=d.astype(np.int32),
        w=w.astype(np.float32), row_ptr=row_ptr.astype(np.int32), deg=deg,
        rtow=rtow, max_w=float(w.max()) if w.size else 0.0)


# ---------------------------------------------------------------------------
# Blocked layout for the edge_relax kernel (relax backend "blocked_pallas")
# ---------------------------------------------------------------------------

class BlockedEdges(NamedTuple):
    """One source-block edge slab with its CSR-of-tiles index (the
    reference's per-slab view; see :meth:`BlockedGraph.slab`)."""
    src_local: torch.Tensor        # [NT*tile_e] int32 — block-local source
    dst: torch.Tensor              # [NT*tile_e] int32 — global destination
    w: torch.Tensor                # [NT*tile_e] float32 (+inf on padding)
    tile_dst: torch.Tensor         # [NT] int32 — dst block per tile
    tile_first: torch.Tensor       # [NT] bool — first tile of each bucket
    bucket_nonempty: torch.Tensor  # [n_dst_blocks] bool


class TileIndex(NamedTuple):
    """The vertex->tile index that drives the CUDA kernels' schedule.

    For each source id ``s`` of a slab set, ``vt_tile[vt_ptr[s]:
    vt_ptr[s+1]]`` lists, ascending and without repeats, the tiles that
    hold a finite-weight slot of ``s`` (padding slots and real edges of
    weight +inf are left out, as ``schedule_tiles`` leaves them out);
    ``forced`` lists the ``tile_first`` tiles.  The tiles a round must
    run are then those of its path sources and the forced ones: exactly
    ``schedule_tiles``' set, found by reading the frontier instead of
    every slot.  numpy arrays on the host, tensors on a device."""
    vt_ptr: object                 # [n_src + 1] int32 offsets into vt_tile
    vt_tile: object                # [entries] int32 tile ids
    forced: object                 # [n_forced] int32 tile_first tiles

    def to(self, device) -> "TileIndex":
        return TileIndex(*(torch.from_numpy(np.ascontiguousarray(a))
                           .to(device) if isinstance(a, np.ndarray)
                           else a.to(device) for a in self))


def _drop_repeats(s, t):
    """``(s, t)`` pairs less those equal to the pair before them."""
    keep = np.ones(s.size, bool)
    keep[1:] = (s[1:] != s[:-1]) | (t[1:] != t[:-1])
    return s[keep], t[keep]


def tile_index(src, w, tile_first, tile_e: int, n_src: int) -> TileIndex:
    """Build the :class:`TileIndex` of a tile-aligned slab set (numpy).

    ``src`` holds the source ids the kernels index with (global ids of a
    :class:`BlockedGraph`, shard-local ones of a shard), below ``n_src``.
    Slots are visited in tile order, so each source's tiles come out
    ascending; repeats within a tile are dropped before the one sort."""
    live = np.flatnonzero(np.isfinite(np.asarray(w)))
    s, t = _drop_repeats(np.asarray(src)[live].astype(np.int32),
                         (live // tile_e).astype(np.int32))
    order = np.argsort(s, kind="stable")
    s, t = _drop_repeats(s[order], t[order])
    counts = np.bincount(s, minlength=n_src)
    if counts.size > n_src:
        raise ValueError(f"source ids outside [0, {n_src})")
    if s.size >= 2 ** 31:
        raise ValueError("the tile index has 2^31 entries or more")
    vt_ptr = np.zeros(n_src + 1, np.int32)
    np.cumsum(counts, out=vt_ptr[1:])
    forced = np.flatnonzero(np.asarray(tile_first)).astype(np.int32)
    return TileIndex(vt_ptr=vt_ptr, vt_tile=t, forced=forced)


@dataclasses.dataclass(frozen=True)
class BlockedGraph:
    """2-D blocked edge layout: edges bucketed by (src block x dst block).

    The reference keeps one slab per source block and launches its kernel
    once per slab.  Here the slabs are stored concatenated, in source
    block order, with *global* source ids: the CUDA kernel relaxes all of
    them in one launch per round, which gives the same (min, min-id)
    result because the per-block combine uses the same rule.  Slab ``b``
    covers tiles ``slab_ptr[b]:slab_ptr[b+1]``.
    """
    n: int                           # true vertex count (pre-padding)
    block_v: int
    n_blocks: int                    # source blocks (== destination blocks)
    n_dst_blocks: int
    tile_e: int
    dense_grid_tiles: int            # per-round cost of the dense scan
    slab_ptr: Tuple[int, ...]        # [n_blocks + 1] tile offsets of slabs
    src: torch.Tensor                # [NT*tile_e] int32 global source id
    dst: torch.Tensor                # [NT*tile_e] int32 global destination
    w: torch.Tensor                  # [NT*tile_e] float32 (+inf padding)
    tile_dst: torch.Tensor           # [NT] int32 dst block per tile
    tile_first: torch.Tensor         # [NT] bool forced first tiles
    bucket_nonempty: torch.Tensor    # [n_blocks, n_dst_blocks] bool
    deg: torch.Tensor                # [n_blocks * block_v] int32, 0-padded
    index: TileIndex                 # vertex->tile index over [0, n_pad)

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.block_v

    @property
    def n_out(self) -> int:
        return self.n_dst_blocks * self.block_v

    def slab(self, b: int) -> BlockedEdges:
        """Source block ``b``'s slab in the reference's per-slab form."""
        lo, hi = self.slab_ptr[b] * self.tile_e, self.slab_ptr[b + 1] * self.tile_e
        t0, t1 = self.slab_ptr[b], self.slab_ptr[b + 1]
        return BlockedEdges(
            src_local=self.src[lo:hi] - b * self.block_v, dst=self.dst[lo:hi],
            w=self.w[lo:hi], tile_dst=self.tile_dst[t0:t1],
            tile_first=self.tile_first[t0:t1],
            bucket_nonempty=self.bucket_nonempty[b])


def _bucket(sb, src, dst, w, *, n_src_blocks, n_dst_blocks, block_v, tile_e,
            src_base=0, n_tiles=0):
    """Bucket edges of many source blocks at once, tile-aligned.

    Edges are stably sorted by (source block ``sb``, destination block),
    so each slab lists its buckets in destination order and each bucket
    keeps the input order.  Every non-empty bucket is padded to a
    multiple of ``tile_e`` with ``w=+inf`` slots whose source is the
    slab's first id (``src_base * block``); a slab with no edges gets one
    all-padding tile so that every slab has at least one.  ``n_tiles > 0``
    pads every slab to exactly that many tiles, the surplus ones repeating
    the slab's last real destination block (the reference's
    ``bucket_edges(..., n_tiles=)``).
    Returns numpy ``(src, dst, w, tile_dst, tile_first, nonempty,
    tiles_per, slab_ptr, index)``, ``index`` the :class:`TileIndex` over
    the ``n_src_blocks * block_v`` source ids.
    """
    db = dst // block_v
    if db.size and (db.min() < 0 or db.max() >= n_dst_blocks):
        raise ValueError(f"dst ids outside the {n_dst_blocks} x {block_v} "
                         "destination range")
    key = sb.astype(np.int64) * n_dst_blocks + db
    order = np.argsort(key, kind="stable")
    key = key[order]
    counts = np.bincount(key, minlength=n_src_blocks * n_dst_blocks)
    tiles_per = -(-counts // tile_e)               # 0 for empty buckets
    per_slab = tiles_per.reshape(n_src_blocks, n_dst_blocks).sum(1)
    need = max(int(per_slab.max(initial=0)), 1)
    if n_tiles and n_tiles < need:
        raise ValueError(f"n_tiles={n_tiles} < required {need}")
    slab_ptr = np.zeros(n_src_blocks + 1, np.int64)
    np.cumsum(np.full(n_src_blocks, n_tiles) if n_tiles
              else np.maximum(per_slab, 1), out=slab_ptr[1:])
    nt = int(slab_ptr[-1])
    # first tile of each bucket: its slab's base + the tiles before it
    within = (np.cumsum(tiles_per.reshape(n_src_blocks, n_dst_blocks), 1)
              - tiles_per.reshape(n_src_blocks, n_dst_blocks))
    bucket_tile0 = (slab_ptr[:-1, None] + within).ravel()
    off = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    pos = bucket_tile0[key] * tile_e + (np.arange(key.size) - off[key])
    slab_of_tile = np.repeat(np.arange(n_src_blocks), np.diff(slab_ptr))
    s_out = np.repeat((slab_of_tile * src_base).astype(np.int32), tile_e)
    d_out = np.zeros(nt * tile_e, np.int32)
    w_out = np.full(nt * tile_e, np.inf, np.float32)
    s_out[pos] = src[order]
    d_out[pos] = dst[order]
    w_out[pos] = w[order]
    n_real = int(tiles_per.sum())
    tile_excl = np.repeat(np.cumsum(tiles_per) - tiles_per, tiles_per)
    real = np.repeat(bucket_tile0, tiles_per) + (np.arange(n_real) - tile_excl)
    tile_dst = np.zeros(nt, np.int32)
    tile_dst[real] = np.repeat(
        np.tile(np.arange(n_dst_blocks, dtype=np.int32), n_src_blocks),
        tiles_per)
    if n_tiles:
        # surplus tiles after a slab's real ones repeat its last dst block
        has = per_slab > 0
        first_pad = slab_ptr[:-1][has] + per_slab[has]
        surplus = n_tiles - per_slab[has]
        pad = np.repeat(first_pad - np.cumsum(surplus) + surplus, surplus) \
            + np.arange(int(surplus.sum()))
        tile_dst[pad] = np.repeat(tile_dst[first_pad - 1], surplus)
    tile_first = np.zeros(nt, bool)
    tile_first[bucket_tile0[counts > 0]] = True
    tile_first[slab_ptr[:-1]] = True          # >= 1 scheduled tile per slab
    nonempty = (counts > 0).reshape(n_src_blocks, n_dst_blocks)
    index = tile_index(s_out, w_out, tile_first, tile_e,
                       n_src_blocks * block_v)
    return (s_out, d_out, w_out, tile_dst, tile_first, nonempty,
            tiles_per.reshape(n_src_blocks, n_dst_blocks), slab_ptr, index)


def bucket_edges(src_local, dst, w, *, n_dst_blocks: int, block_v: int,
                 tile_e: int):
    """Bucket one slab's edges by destination block, tile-aligned.

    Returns numpy arrays ``(src_local, dst, w, tile_dst, tile_first,
    bucket_nonempty, tile_ptr)`` exactly as the reference does;
    ``tile_ptr`` [n_dst_blocks + 1] is the CSR-of-tiles index.
    """
    src_local = np.asarray(src_local, np.int32)
    dst = np.asarray(dst, np.int32)
    w = np.asarray(w, np.float32)
    s, d, ww, td, tf, ne, tiles_per, _, _ = _bucket(
        np.zeros(src_local.shape, np.int64), src_local, dst, w,
        n_src_blocks=1, n_dst_blocks=n_dst_blocks, block_v=block_v,
        tile_e=tile_e)
    tile_ptr = np.zeros(n_dst_blocks + 1, np.int64)
    np.cumsum(tiles_per[0], out=tile_ptr[1:])
    return s, d, ww, td, tf, ne[0], tile_ptr.astype(np.int32)


def default_geometry(n: int, device) -> Tuple[int, int]:
    """``(block_v, tile_e)`` when the caller gives neither.

    On the CPU these are the reference's defaults, so the physical tile
    counters follow its layout.  The CUDA kernel keeps no destination
    block in shared memory, so a block that covers every vertex costs it
    nothing: the layout is then one bucket in CSR order, padded by less
    than one tile, where 512 x 512 buckets would pad a scale-free graph
    many times over (63.5x on kronecker(20, 16)).
    """
    if torch.device(device).type == "cuda":
        return max(-(-n // CUDA_TILE_E), 1) * CUDA_TILE_E, CUDA_TILE_E
    return DEFAULT_BLOCK_V, DEFAULT_TILE_E


def build_blocked(g, *, block_v: int | None = None,
                  tile_e: int | None = None, device=None) -> BlockedGraph:
    """Pre-bucket a graph (``HostGraph`` or ``DeviceGraph``) for the kernel.

    Bucketing runs on the host in numpy; the layout lands on ``device``
    (default: the device of a ``DeviceGraph``).  ``block_v``/``tile_e``
    left out come from :func:`default_geometry`.
    """
    if device is None:
        if not isinstance(g, DeviceGraph):
            raise ValueError("build_blocked needs device= for a HostGraph")
        device = g.device
    if block_v is None or tile_e is None:
        auto_v, auto_e = default_geometry(int(g.deg.shape[0]), device)
        block_v = auto_v if block_v is None else block_v
        tile_e = auto_e if tile_e is None else tile_e
    as_np = (lambda a: a.cpu().numpy()) if isinstance(g, DeviceGraph) \
        else np.asarray
    src = as_np(g.src).astype(np.int32)
    dst = as_np(g.dst).astype(np.int32)
    w = as_np(g.w).astype(np.float32)
    deg = as_np(g.deg)
    n = int(deg.shape[0])
    n_blocks = max(-(-n // block_v), 1)
    s, d, ww, td, tf, ne, _, slab_ptr, index = _bucket(
        src // block_v, src, dst, w, n_src_blocks=n_blocks,
        n_dst_blocks=n_blocks, block_v=block_v, tile_e=tile_e,
        src_base=block_v)
    # what the reference's dense (n_dst_blocks x n_tiles) grid scanned
    per_block = np.bincount(src // block_v, minlength=n_blocks)
    dense = n_blocks * int(np.maximum(-(-per_block // tile_e), 1).sum())
    deg_pad = np.zeros(n_blocks * block_v, np.int32)
    deg_pad[:n] = deg
    dev = torch.device(device)
    t = lambda a: torch.from_numpy(a).to(dev)
    return BlockedGraph(
        n=n, block_v=block_v, n_blocks=n_blocks, n_dst_blocks=n_blocks,
        tile_e=tile_e, dense_grid_tiles=dense,
        slab_ptr=tuple(int(x) for x in slab_ptr), src=t(s), dst=t(d),
        w=t(ww), tile_dst=t(td), tile_first=t(tf), bucket_nonempty=t(ne),
        deg=t(deg_pad), index=index.to(dev))


def shard_block_v(block: int, block_v: int) -> int:
    """Largest divisor of the shard block size that is <= ``block_v``.

    Shard slabs must tile the owner block exactly, so the requested
    ``block_v`` is snapped down to a divisor of ``block``.
    """
    if block <= 0:
        raise ValueError("block must be positive")
    for d in range(min(block_v, block), 0, -1):
        if block % d == 0:
            return d
    return 1


def shard_geometry(block: int, device) -> Tuple[int, int]:
    """``(block_v, tile_e)`` of a shard layout when the caller gives
    neither: on the card one source block per shard (the owner block)
    and 256-slot tiles, as :func:`default_geometry` does for one device;
    on the CPU the reference's defaults."""
    if torch.device(device).type == "cuda":
        return block, CUDA_TILE_E
    return DEFAULT_BLOCK_V, DEFAULT_TILE_E


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """Blocked layout of one shard's CSR slice, on the host (numpy).

    Sources are the shard's owner block ``[src_base, src_base + block)``,
    tiled by ``n_blocks`` source blocks of ``block_v``; destinations span
    the global padded range of ``n_dst_blocks`` blocks.  The reference
    keeps one slab per source block; here the slabs are stored
    concatenated, in source block order, with the slab offsets already
    added: ``src`` holds shard-local ids in ``[0, block)``, the index
    space of the shard's ``dist``/``paths``/``parent`` slice.  Slab ``b``
    covers tiles ``slab_ptr[b]:slab_ptr[b+1]``.
    """
    n: int                           # true vertex count (pre-padding)
    block_v: int
    n_blocks: int                    # source blocks in the owner block
    n_dst_blocks: int                # destination blocks (global range)
    src_base: int                    # global id of the shard's first source
    tile_e: int
    dense_grid_tiles: int            # per-round cost of the dense scan
    slab_ptr: Tuple[int, ...]
    src: np.ndarray                  # [NT*tile_e] int32 shard-local source
    dst: np.ndarray                  # [NT*tile_e] int32 global destination
    w: np.ndarray                    # [NT*tile_e] float32 (+inf padding)
    tile_dst: np.ndarray             # [NT] int32 dst block per tile
    tile_first: np.ndarray           # [NT] bool forced first tiles
    bucket_nonempty: np.ndarray      # [n_blocks, n_dst_blocks] bool
    deg: np.ndarray                  # [n_blocks * block_v] int32, 0-padded
    index: TileIndex                 # vertex->tile index over [0, block)

    @property
    def n_out(self) -> int:
        return self.n_dst_blocks * self.block_v

    def slab(self, b: int) -> BlockedEdges:
        """Source block ``b``'s slab in the reference's per-slab form
        (numpy arrays, block-local source ids)."""
        t0, t1 = self.slab_ptr[b], self.slab_ptr[b + 1]
        lo, hi = t0 * self.tile_e, t1 * self.tile_e
        return BlockedEdges(
            src_local=self.src[lo:hi] - b * self.block_v, dst=self.dst[lo:hi],
            w=self.w[lo:hi], tile_dst=self.tile_dst[t0:t1],
            tile_first=self.tile_first[t0:t1],
            bucket_nonempty=self.bucket_nonempty[b])


def slice_for_shard(g, shard: int, n_shards: int, *,
                    block_v: int = DEFAULT_BLOCK_V,
                    tile_e: int = DEFAULT_TILE_E,
                    n_tiles: int = 0) -> ShardSlice:
    """Blocked layout for one shard's CSR slice (sources = owner block).

    Shard ``q`` owns ``[q*B, (q+1)*B)`` with ``B = ceil(n / n_shards)``
    and every edge whose source it owns; ``block_v`` is snapped to a
    divisor of ``B`` (:func:`shard_block_v`) and destinations span the
    padded ``n_shards * B`` range.  ``n_tiles > 0`` pads every slab to
    that many tiles (uniform shapes across shards).  ``g`` has numpy (or
    CPU) ``src``/``dst``/``w``/``deg``.  Host side, numpy.
    """
    src = np.asarray(g.src).astype(np.int64)
    dst = np.asarray(g.dst).astype(np.int32)
    w = np.asarray(g.w).astype(np.float32)
    deg = np.asarray(g.deg)
    n = int(deg.shape[0])
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} out of range for {n_shards}")
    block = -(-n // n_shards)
    bv = shard_block_v(block, block_v)
    n_src_blocks = block // bv
    n_dst_blocks = block * n_shards // bv
    lo = shard * block
    mine = (src >= lo) & (src < lo + block)
    local = (src[mine] - lo).astype(np.int32)
    s, d, ww, td, tf, ne, _, slab_ptr, index = _bucket(
        local // bv, local, dst[mine], w[mine], n_src_blocks=n_src_blocks,
        n_dst_blocks=n_dst_blocks, block_v=bv, tile_e=tile_e, src_base=bv,
        n_tiles=n_tiles)
    per_block = np.bincount(local // bv, minlength=n_src_blocks)
    dense = n_dst_blocks * int(np.maximum(-(-per_block // tile_e), 1).sum())
    deg_pad = np.zeros(block, np.int32)
    hi = min(lo + block, n)
    if hi > lo:
        deg_pad[:hi - lo] = deg[lo:hi]
    return ShardSlice(
        n=n, block_v=bv, n_blocks=n_src_blocks, n_dst_blocks=n_dst_blocks,
        src_base=lo, tile_e=tile_e, dense_grid_tiles=dense,
        slab_ptr=tuple(int(x) for x in slab_ptr), src=s, dst=d, w=ww,
        tile_dst=td, tile_first=tf, bucket_nonempty=ne, deg=deg_pad,
        index=index)


def degree_bucket_np(deg: np.ndarray) -> np.ndarray:
    """Bucket index for the highD() histogram (exact < EXACT_DEG, log2 above)."""
    deg = np.asarray(deg)
    small = deg < EXACT_DEG
    log_b = EXACT_DEG + np.clip(
        np.floor(np.log2(np.maximum(deg, 1))).astype(np.int32) - 5, 0, 25)
    return np.where(small, deg, log_b).astype(np.int32)


def degree_bucket(deg: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`degree_bucket_np`, rounding ``log2`` in float32
    as the reference engine does (it differs from the exact bucket at some
    powers of two and just below others)."""
    logd = f32math.log(torch.clamp(deg, min=1).to(torch.float32)) \
        * f32math.LOG2_SCALE
    log_b = EXACT_DEG + torch.clamp(torch.floor(logd).to(torch.int32) - 5,
                                    0, 25)
    return torch.where(deg < EXACT_DEG, deg, log_b).to(torch.int32)


def bucket_representative(device=None) -> torch.Tensor:
    """Representative degree value per histogram bucket (midpoint of range)."""
    reps = np.arange(N_DEG_BUCKETS, dtype=np.float32)
    for b in range(EXACT_DEG, N_DEG_BUCKETS):
        lo = 2 ** (b - EXACT_DEG + 5)
        reps[b] = 1.5 * lo  # geometric midpoint of [2^k, 2^{k+1})
    return torch.from_numpy(reps).to(device)
