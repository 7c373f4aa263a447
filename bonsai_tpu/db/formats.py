"""Database serialization.

Two formats:

1. Native ``BTPU1``: magic + JSON header + raw little-endian key/value
   arrays.  Flat sorted arrays are the canonical content (the bucketized
   probe table is rebuilt vectorized on load); this is the checkpoint format
   for all builders.

2. Bonsai-compatible import/export of the reference ``Database<khash_t(c)>``
   / ``Database<khash_t(64)>`` file layout (database.h:33-102 +
   util.h:281-372): header {u32 k, u32 w, (k-1) bytes spacing}, then a raw
   khash memory image {u64 n_buckets, n_occupied, size, upper_bound; u32
   flags[fsize]; u64 keys[nb]; u32|u64 vals[nb]}.  The exporter reproduces
   klib khash's exact bucket count, hash (khash64.h:425) and triangular
   probing so the file round-trips through the reference loader; slot layout
   for colliding keys follows ascending-key insertion order (any insertion
   order yields a valid khash).

   Note the reference writes the spacing vector as one byte per entry while
   the in-memory type is uint16 (database.h:48,99) — gaps are truncated to
   a byte on disk; we reproduce that.
"""

from __future__ import annotations

import gzip
import io
import json
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.spacer import Spacer
from .table import KmerTable

MAGIC = b"BTPU1\n"
KH_UPPER = 0.77


@dataclass
class Database:
    """A loaded database: table + seed geometry."""

    table: KmerTable
    k: int
    w: int
    gaps: List[int]
    canonicalize: bool = True
    scheme: str = "lex"
    meta: dict = field(default_factory=dict)

    @property
    def spacer(self) -> Spacer:
        return Spacer(self.k, self.w, self.gaps)


# -- native format ------------------------------------------------------------

def _write_native(path: str, header: dict, keys: np.ndarray,
                  vals: np.ndarray, compress: Optional[str] = None):
    """Arrays-level BTPU1 writer (shared by save_database and the sharded
    saver, which must not pay a cuckoo placement per shard just to
    serialize flat arrays)."""
    hb = json.dumps(header).encode()
    if compress is None and path.endswith(".gz"):
        compress = "gz"
    opener = gzip.open if compress == "gz" else open
    with opener(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<I", len(hb)))
        fh.write(hb)
        fh.write(np.asarray(keys).astype("<u8").tobytes())
        fh.write(
            np.asarray(vals).astype(vals.dtype.newbyteorder("<")).tobytes()
        )


def save_database(db: Database, path: str, compress: Optional[str] = None):
    header = dict(
        k=db.k,
        w=db.w,
        gaps=list(db.gaps),
        canonicalize=bool(db.canonicalize),
        scheme=db.scheme,
        n=int(db.table.n),
        val_dtype=str(db.table.vals_sorted.dtype),
        meta=db.meta,
    )
    _write_native(path, header, db.table.keys_sorted, db.table.vals_sorted,
                  compress)


def read_database_arrays(path: str):
    """(header, keys, vals) without building the probe layout — shard
    loaders that rebuild the table with a forced geometry use this to
    avoid paying cuckoo placement twice."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        magic = fh.read(len(MAGIC))
        if magic != MAGIC:
            return None
        (hlen,) = struct.unpack("<I", fh.read(4))
        header = json.loads(fh.read(hlen))
        n = header["n"]
        keys = np.frombuffer(fh.read(8 * n), dtype="<u8").astype(np.uint64)
        vdt = np.dtype(header["val_dtype"])
        vals = np.frombuffer(
            fh.read(vdt.itemsize * n), dtype=vdt.newbyteorder("<")
        ).astype(vdt)
    return header, keys, vals


def load_database(path: str) -> Database:
    got = read_database_arrays(path)
    if got is None:
        # Not native: fall through to the reference khash image
        # (database.h:33-56) so `classify` consumes bonsai DBs directly.
        return import_bonsai_database(path)
    header, keys, vals = got
    table = KmerTable(keys, vals)
    return Database(
        table=table,
        k=header["k"],
        w=header["w"],
        gaps=header["gaps"],
        canonicalize=header.get("canonicalize", True),
        scheme=header.get("scheme", "lex"),
        meta=header.get("meta", {}),
    )


# -- probe image (classify-ready memory image) --------------------------------

@dataclass
class ProbeImage:
    """A classify-ready slot image: exactly what the classifier uploads,
    memory-mappable from disk.  The device analog of the reference's khash
    memory-image load (util.h:281-372, database.h:33-56): where the
    reference fread()s the live hash table bytes and probes them as-is,
    this stores the quotient-cuckoo slot words ALREADY packed with the
    classifier's payload (orig taxid << 32 | tree-compact idx), so a
    classify process mmaps + uploads with no cuckoo re-placement and no
    host-side packing transients."""

    slots: np.ndarray       # (nb, SLOTS) u64, mmap-backed
    vals: np.ndarray        # inline: (u,) u64 unique packed values;
                            # else (nb, SLOTS) u64 flat values
    inline: bool
    lgnb: int
    vbits: int
    n: int
    n_distinct: int
    k: int
    w: int
    gaps: List[int]
    canonicalize: bool
    tree_digest: str


def tree_digest(tree) -> str:
    """Cheap fingerprint of a TaxTree's structure: a probe image packs
    TREE-COMPACT indices, so it is only valid with the tree it was built
    against."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(tree.tax_ids).tobytes())
    h.update(np.ascontiguousarray(tree.parent).tobytes())
    return h.hexdigest()[:16]


def save_probe_image(dirpath: str, db: Database, tree) -> None:
    """Write a classify-ready probe image directory for (db, tree):
    slots.npy + vals.npy (mmap-loadable) + meta.json."""
    import os

    table = db.table
    compact_vals = tree.compact(table.vals_sorted, missing_ok=True)
    packed = (
        table.vals_sorted.astype(np.uint64) << np.uint64(32)
    ) | compact_vals.astype(np.uint32).astype(np.uint64)
    slots, vals, inline = table.arrays_np(packed)
    os.makedirs(dirpath, exist_ok=True)
    np.save(os.path.join(dirpath, "slots.npy"), slots)
    np.save(os.path.join(dirpath, "vals.npy"), np.asarray(vals))
    meta = dict(
        format="btpu-probe-image", version=1,
        inline=bool(inline), lgnb=table.lgnb, vbits=table.vbits,
        n=table.n, n_distinct=int(np.unique(compact_vals).size),
        k=db.k, w=db.w, gaps=list(map(int, db.gaps)),
        canonicalize=bool(db.canonicalize),
        tree_digest=tree_digest(tree),
    )
    with open(os.path.join(dirpath, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def load_probe_image(dirpath: str) -> ProbeImage:
    """mmap a probe image directory (see save_probe_image)."""
    import os

    with open(os.path.join(dirpath, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("format") != "btpu-probe-image":
        raise ValueError(f"{dirpath}: not a probe image directory")
    slots = np.load(os.path.join(dirpath, "slots.npy"), mmap_mode="r")
    vals = np.load(os.path.join(dirpath, "vals.npy"), mmap_mode="r")
    return ProbeImage(
        slots=slots, vals=vals, inline=meta["inline"], lgnb=meta["lgnb"],
        vbits=meta["vbits"], n=meta["n"], n_distinct=meta["n_distinct"],
        k=meta["k"], w=meta["w"], gaps=meta["gaps"],
        canonicalize=meta["canonicalize"],
        tree_digest=meta["tree_digest"],
    )


# -- sharded on-disk layout ---------------------------------------------------

# Per-device slot budget, from the probe-cost sweep of tools/scale_bench.py
# (`probe`) on an NVIDIA H100 80GB HBM3 at its 700 W power limit: 8192x74
# classify-shaped probes (~80% hits) cost 0.51, 0.61 and 0.58 ns/probe at
# 10M, 40M and 160M keys (134 MB, 537 MB and 2.1 GB of slots; L2 is 50 MB).
# There is no step beyond the L2 boundary up to the largest size measured,
# so the budget is that size: shard only tables whose slots exceed 2 GiB.
SHARD_SLOT_BUDGET = 2 << 30


def table_slot_bytes(n_kmers: int) -> int:
    """Slot-array bytes of a quotient-cuckoo table holding n_kmers."""
    from .table import MAX_LOAD, SLOTS, _next_pow2

    nb = max(
        _next_pow2(max(int(np.ceil(n_kmers / (SLOTS * MAX_LOAD))), 1)), 4
    )
    return nb * SLOTS * 8


def recommended_shards(n_kmers: int,
                       budget_bytes: int = SHARD_SLOT_BUDGET) -> int:
    """Smallest shard count keeping every rank's slot array within the
    measured per-device budget (the automatic placement policy for
    `build --shards auto` and multi-device deployments)."""
    s = 1
    while table_slot_bytes(-(-n_kmers // s)) > budget_bytes and s < 65536:
        s *= 2
    return s

def save_database_sharded(db: Database, dirpath: str, ndb: int,
                          compress: Optional[str] = None) -> None:
    """Write the DB as ndb per-shard files + a JSON manifest (SURVEY §5
    checkpoint/persistence: 'flat arrays in a sharded on-disk layout').

    The partition is the HASH-PREFIX ownership used by the all_to_all
    routed probe (db/table.py shard_owner), so a host serving 'db'
    rank s loads exactly shard-s.btpu and nothing else — DB load I/O
    scales with 1/ndb per host.

    The manifest records the AGREED common bucket count ``nb``: the saver
    actually builds every shard's cuckoo placement (HashShardedTable) and
    negotiates growth here, once, so per-process lazy loading
    (ShardedClassifier.from_sharded_dir) can never hit a shard that needs
    a bucket count the other processes don't know about.  It also records
    the DB's distinct values (``uniq_vals.npy``) so per-process loaders
    can share one global value dictionary without seeing foreign shards."""
    import os

    from .table import HashShardedTable

    os.makedirs(dirpath, exist_ok=True)
    keys, vals = db.table.keys_sorted, db.table.vals_sorted
    ht = HashShardedTable(db.table, ndb)
    ext = ".btpu.gz" if compress == "gz" else ".btpu"
    shard_files = []
    shard_n = []
    for s in range(ndb):
        p = ht.parts[s]
        header = dict(
            k=db.k, w=db.w, gaps=list(db.gaps),
            canonicalize=bool(db.canonicalize), scheme=db.scheme,
            n=int(p.size), val_dtype=str(vals.dtype), meta=db.meta,
        )
        fn = f"shard-{s:05d}{ext}"
        _write_native(os.path.join(dirpath, fn), header, keys[p], vals[p],
                      compress)
        shard_files.append(fn)
        shard_n.append(int(p.size))
    uniq = np.unique(vals.astype(np.uint64))
    np.save(os.path.join(dirpath, "uniq_vals.npy"), uniq)
    manifest = dict(
        format="bonsai-tpu-sharded-v1",
        ndb=ndb,
        n=int(db.table.n),
        nb=int(ht.nb),  # agreed per-shard bucket count (no growth on load)
        shard_n=shard_n,
        k=db.k, w=db.w, gaps=list(db.gaps),
        canonicalize=bool(db.canonicalize), scheme=db.scheme,
        partition="splitmix64-prefix",  # shard_owner(key, ndb)
        shards=shard_files,
        uniq_vals="uniq_vals.npy",
        meta=db.meta,
    )
    with open(os.path.join(dirpath, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)


def save_sharded_arrays(keys: np.ndarray, vals: np.ndarray, dirpath: str,
                        ndb: int, k: int, w: int, gaps: List[int],
                        canonicalize: bool = True, scheme: str = "lex",
                        meta: Optional[dict] = None,
                        place_check: bool = True) -> None:
    """Streaming sharded save from sorted (keys, vals) arrays — the
    config-5 scale path.  Unlike save_database_sharded it never builds a
    GLOBAL cuckoo placement (a 10^9-key placement costs tens of GB of
    transients for a structure per-rank loaders rebuild per shard), and
    it negotiates the common bucket count by placing ONE shard at a time
    and freeing it.  Output layout is identical to save_database_sharded
    (same manifest, loadable by load_database_sharded /
    ShardedClassifier.from_sharded_dir)."""
    import os

    from .table import MAX_LOAD, SLOTS, KmerTable, _next_pow2, shard_owner

    os.makedirs(dirpath, exist_ok=True)
    keys = np.asarray(keys, dtype=np.uint64)
    vals = np.asarray(vals)
    owner = shard_owner(keys, ndb)
    shard_files, shard_n = [], []
    counts = np.bincount(owner, minlength=ndb)
    nb = max(
        _next_pow2(int(np.ceil(max(int(counts.max()), 1)
                               / (SLOTS * MAX_LOAD)))), 4
    )
    # one stable argsort groups the keys by owner (within-owner order
    # stays ascending-index == ascending-key, so each slice is sorted);
    # at 10^9 keys this replaces 2*ndb full scans of the owner array
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(
        owner[order], np.arange(ndb + 1, dtype=owner.dtype)
    )

    def part(s):
        return order[bounds[s]:bounds[s + 1]]

    # placement feasibility at the common nb, one shard at a time (rare
    # growth restarts the check at the larger nb; files are written once
    # after the final nb is known)
    if place_check:
        s = 0
        while s < ndb:
            p = part(s)
            t = KmerTable(keys[p], vals[p], min_nb=nb)
            if t.nb != nb:
                nb = t.nb
                s = 0
                continue
            del t
            s += 1
    for s in range(ndb):
        p = part(s)
        header = dict(
            k=k, w=w, gaps=list(gaps), canonicalize=bool(canonicalize),
            scheme=scheme, n=int(p.size), val_dtype=str(vals.dtype),
            meta=meta or {},
        )
        fn = f"shard-{s:05d}.btpu"
        _write_native(os.path.join(dirpath, fn), header, keys[p], vals[p],
                      None)
        shard_files.append(fn)
        shard_n.append(int(p.size))
    uniq = np.unique(vals.astype(np.uint64))
    np.save(os.path.join(dirpath, "uniq_vals.npy"), uniq)
    manifest = dict(
        format="bonsai-tpu-sharded-v1",
        ndb=ndb,
        n=int(keys.size),
        nb=int(nb),
        shard_n=shard_n,
        k=k, w=w, gaps=list(gaps),
        canonicalize=bool(canonicalize), scheme=scheme,
        partition="splitmix64-prefix",
        shards=shard_files,
        uniq_vals="uniq_vals.npy",
        meta=meta or {},
    )
    with open(os.path.join(dirpath, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)


def load_database_sharded(dirpath: str,
                          ranks: Optional[List[int]] = None) -> Database:
    """Load a sharded DB directory (all shards, or only `ranks` — the
    per-host subset of a multi-host run).  Shard key ranges interleave, so the
    merged keys are re-sorted (cheap: concatenation of sorted runs)."""
    import os

    with open(os.path.join(dirpath, "manifest.json")) as fh:
        mf = json.load(fh)
    if mf.get("format") != "bonsai-tpu-sharded-v1":
        raise ValueError(f"not a sharded DB dir: {dirpath}")
    which = range(mf["ndb"]) if ranks is None else ranks
    parts = [
        load_database(os.path.join(dirpath, mf["shards"][s])) for s in which
    ]
    keys = np.concatenate([p.table.keys_sorted for p in parts])
    vals = np.concatenate([p.table.vals_sorted for p in parts])
    order = np.argsort(keys, kind="stable")
    table = KmerTable(keys[order], vals[order])
    return Database(
        table=table, k=mf["k"], w=mf["w"], gaps=mf["gaps"],
        canonicalize=mf.get("canonicalize", True),
        scheme=mf.get("scheme", "lex"), meta=mf.get("meta", {}),
    )


# -- bonsai khash image -------------------------------------------------------

def _kh_hash(keys: np.ndarray) -> np.ndarray:
    k = keys.astype(np.uint64)
    return ((k >> np.uint64(33)) ^ k ^ (k << np.uint64(11))) & np.uint64(0xFFFFFFFF)


def _kroundup64(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def _fsize(nb: int) -> int:
    return 1 if nb < 16 else nb >> 4


def read_bonsai_database(path: str):
    """Read a reference Database file -> (k, w, gaps, keys, vals, val_width).

    Detects the value width (4 for khash_t(c), 8 for khash_t(64)) from the
    file size."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        data = fh.read()
    k, w = struct.unpack_from("<II", data, 0)
    off = 8
    gaps = list(data[off : off + k - 1])
    off += k - 1
    nb, n_occ, size, upper = struct.unpack_from("<QQQQ", data, off)
    off += 32
    fs = _fsize(nb)
    flags = np.frombuffer(data, dtype="<u4", count=fs, offset=off)
    off += 4 * fs
    keys = np.frombuffer(data, dtype="<u8", count=nb, offset=off)
    off += 8 * nb
    remaining = len(data) - off
    val_width = 8 if remaining >= 8 * nb else 4
    vals = np.frombuffer(data, dtype=f"<u{val_width}", count=nb, offset=off)
    # occupied slots: 2-bit flag == 0 (khash64.h:169-171)
    idx = np.arange(nb)
    fl = (flags[idx >> 4] >> ((idx & 0xF) << 1).astype(np.uint32)) & 3
    occ = fl == 0
    okeys = keys[occ].astype(np.uint64)
    ovals = vals[occ]
    order = np.argsort(okeys, kind="stable")
    return int(k), int(w), gaps, okeys[order], ovals[order], val_width


def import_bonsai_database(path: str) -> Database:
    k, w, gaps, keys, vals, vw = read_bonsai_database(path)
    if np.unique(keys).size != keys.size:
        raise ValueError(f"{path}: duplicate keys in khash image")
    return Database(
        table=KmerTable(keys, vals),
        k=k,
        w=w,
        gaps=gaps,
        meta=dict(source="bonsai", val_width=vw),
    )


def _khash_layout(keys: np.ndarray, vals: np.ndarray):
    """Place sorted unique keys into a klib-khash-compatible slot layout.

    Vectorized round-based insertion along each key's triangular probe
    sequence (khash64.h kh_put): in every round, the first unplaced key
    targeting an empty slot wins it; losers advance one probe step.  The
    occupancy-monotonicity of the final table guarantees lookup correctness
    for any such order (see module docstring)."""
    n = keys.size
    nb = _kroundup64(max(n, 4))
    while n >= int(nb * KH_UPPER + 0.5):
        nb <<= 1
    mask = np.uint64(nb - 1)
    slot_keys = np.zeros(nb, dtype=np.uint64)
    slot_vals = np.zeros(nb, dtype=vals.dtype)
    occupied = np.zeros(nb, dtype=bool)
    if n:
        h = _kh_hash(keys)
        pos = (h & mask).astype(np.int64)
        step = np.zeros(n, dtype=np.int64)
        alive = np.ones(n, dtype=bool)
        ids = np.arange(n)
        while alive.any():
            ai = ids[alive]
            cand = pos[ai]
            empty = ~occupied[cand]
            ei = ai[empty]
            cand_e = cand[empty]
            uniq, first = np.unique(cand_e, return_index=True)
            winners = ei[first]
            slot_keys[pos[winners]] = keys[winners]
            slot_vals[pos[winners]] = vals[winners]
            occupied[pos[winners]] = True
            alive[winners] = False
            rest = alive.copy()
            step[rest] += 1
            pos[rest] = (pos[rest] + step[rest]) & np.int64(nb - 1)
    return nb, slot_keys, slot_vals, occupied


def write_bonsai_database(db: Database, path: str, compress: bool = False):
    """Write a Database loadable by the reference `Database<khash_t(T)>`
    constructor (T inferred from value dtype)."""
    keys = db.table.keys_sorted
    vals = db.table.vals_sorted
    nb, sk, sv, occ = _khash_layout(keys, vals)
    n = keys.size
    fs = _fsize(nb)
    flags = np.full(fs, 0xAAAAAAAA, dtype=np.uint32)
    idx = np.nonzero(occ)[0]
    # clear both bits for occupied slots
    word = idx >> 4
    shiftb = ((idx & 0xF) << 1).astype(np.uint32)
    clear = (np.uint32(3) << shiftb).astype(np.uint32)
    np.bitwise_and.at(flags, word, ~clear)
    gaps = bytes((g & 0xFF) for g in db.gaps)
    buf = io.BytesIO()
    buf.write(struct.pack("<II", db.k, db.w))
    buf.write(gaps)
    upper = int(nb * KH_UPPER + 0.5)
    buf.write(struct.pack("<QQQQ", nb, n, n, upper))
    buf.write(flags.astype("<u4").tobytes())
    buf.write(sk.astype("<u8").tobytes())
    buf.write(sv.astype(sv.dtype.newbyteorder("<")).tobytes())
    opener = gzip.open if compress or path.endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(buf.getvalue())
