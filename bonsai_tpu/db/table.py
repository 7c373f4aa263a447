"""Quotient cuckoo k-mer table: device-memory-resident, gather-probed.

Vectorized replacement for the khash classify DB
(/root/reference/klib khash via include/bonsai/util.h:159-163).  khash's
scalar quadratic probing has unbounded, data-dependent probe chains —
poison for a vectorized probe that must execute its worst case for every
lane.  Here a probe is exactly TWO 32-byte row gathers plus one
small-table value gather, and the layout minimizes the gathered table's
bytes (random row gathers are the probe's cost; whether the 32-byte row
fits the GPU's access granularity best is an open question, ROADMAP S3):

* keys are stored as the QUOTIENT of an invertible hash — zero
  information loss, no false positives:

      h  = splitmix64(kmer)            (bijective)
      b1 = h & (nb-1)                  (nb a power of two)
      q  = h >> log2(nb)
      b2 = b1 ^ (g(q) & (nb-1))        (partial-key cuckoo: the second
                                        bucket is derivable from what the
                                        slot stores)

* a slot is one u64:  [occupied:1 | choice:1 | q:qbits | val_idx:vbits]
  with qbits = 64-log2(nb) and vbits = log2(nb)-2.  A probe compares
  (slot & ~vmask) against a single expected word per choice — one AND +
  compare per lane.  Empty slots are all-zero and can never match (the
  occupied bit is set in every expected word).

* values live OUT of the hot rows: when the DB has few distinct values
  (the common case — LCA taxids), val_idx indexes a small unique-values
  array (a tiny table stays cache-resident); otherwise a parallel
  slot-indexed u64 array is used and the value is one element gather at
  the matched slot.

Buckets have SLOTS=4 slots (one 32B row).  Build is host-side numpy:
greedy two-round placement + vectorized random-walk cuckoo eviction,
growing the table if a build doesn't converge (two-choice, 4-slot load
threshold ~0.93; we size at <= 0.87).  Deterministic throughout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core import hashes

SLOTS = 4
BSALT = np.uint64(0xA24BAED4963EE407)
MAX_LOAD = 0.87


def _sorted_u64(a: np.ndarray) -> np.ndarray:
    """Sort a u64 array (native LSD radix when available)."""
    from ..native import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "btpu_radix_sort_u64") and a.size:
        a = np.ascontiguousarray(a, dtype=np.uint64)
        lib.btpu_radix_sort_u64(a.ctypes.data, a.size)
        return a
    return np.sort(a)

_OCC = np.uint64(1) << np.uint64(63)
_CHOICE = np.uint64(1) << np.uint64(62)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 0)


class KmerTable:
    """``keys_sorted`` / ``vals_sorted`` are the canonical content (sorted
    by key); the quotient-slot layout is a derived probe structure."""

    def __init__(self, keys_sorted: np.ndarray, vals_sorted: np.ndarray,
                 load_factor: float = MAX_LOAD, min_nb: int = 0):
        keys_sorted = np.asarray(keys_sorted, dtype=np.uint64)
        vals_sorted = np.asarray(vals_sorted)
        if keys_sorted.ndim != 1 or keys_sorted.shape != vals_sorted.shape:
            raise ValueError("keys/vals must be matching 1-D arrays")
        if keys_sorted.size > 1 and not np.all(keys_sorted[1:] > keys_sorted[:-1]):
            raise ValueError("keys must be sorted and unique")
        self.keys_sorted = keys_sorted
        self.vals_sorted = vals_sorted
        self.n = int(keys_sorted.size)
        self._h = hashes.splitmix64(keys_sorted)
        nb = max(
            _next_pow2(max(int(np.ceil(self.n / (SLOTS * load_factor))), 1)),
            4,
            _next_pow2(min_nb) if min_nb else 4,
        )
        while not self._try_build(nb):
            nb <<= 1
        self._np_arrays = None
        self._jax_arrays = None

    # -- bucket candidates -------------------------------------------------
    @staticmethod
    def _split(h, lgnb: int, xp=np):
        """(b1, q, b2) for hashed keys h."""
        mask = xp.uint64((1 << lgnb) - 1)
        b1 = h & mask
        q = h >> xp.uint64(lgnb)
        g = hashes.splitmix64(q ^ xp.uint64(BSALT))
        b2 = b1 ^ (g & mask)
        return b1, q, b2

    def _buckets_of(self, keys, xp=np):
        h = hashes.splitmix64(keys)
        b1, _, b2 = self._split(h, self.lgnb, xp)
        return b1.astype(xp.int64), b2.astype(xp.int64)

    # -- build --------------------------------------------------------------
    def _try_build(self, nb: int, max_rounds: int = 500) -> bool:
        n = self.n
        self.nb = nb
        self.lgnb = int(np.log2(nb))
        self.qbits = 64 - self.lgnb
        self.vbits = max(self.lgnb - 2, 0)
        if n:
            nat = self._try_build_native(nb)
            if nat is not None:
                return nat
        owner = np.full(nb * SLOTS, -1, dtype=np.int64)
        choice = np.zeros(nb * SLOTS, dtype=np.uint8)
        if n == 0:
            self.owner, self.choice = owner, choice
            self._finalize()
            return True
        b1_, q_, b2_ = self._split(self._h, self.lgnb)
        b1 = b1_.astype(np.int64)
        b2 = b2_.astype(np.int64)

        counts = np.zeros(nb, dtype=np.int64)
        homeless = np.arange(n)

        def greedy(idx, b, ch):
            nonlocal counts
            if idx.size == 0:
                return idx
            # radix sort of packed (bucket, idx) beats argsort+searchsorted;
            # low-32 idx keeps stable tie order
            pack = (b[idx].astype(np.uint64) << np.uint64(32)) | idx.astype(
                np.uint64
            )
            pack = _sorted_u64(pack)
            si = (pack & np.uint64(0xFFFFFFFF)).astype(np.int64)
            sb = (pack >> np.uint64(32)).astype(np.int64)
            pos = np.arange(sb.size, dtype=np.int64)
            first = np.empty(sb.size, dtype=bool)
            first[0] = True
            first[1:] = sb[1:] != sb[:-1]
            run_start = np.maximum.accumulate(np.where(first, pos, 0))
            rank = pos - run_start
            free = SLOTS - counts[sb]
            win = rank < free
            wi = si[win]
            lane = counts[sb[win]] + rank[win]
            slot = sb[win] * SLOTS + lane
            owner[slot] = wi
            choice[slot] = ch
            counts = counts + np.bincount(sb[win], minlength=nb)
            return si[~win]

        homeless = greedy(homeless, b1, 0)
        homeless = greedy(homeless, b2, 1)

        for rnd in range(max_rounds):
            if homeless.size == 0:
                break
            k = self.keys_sorted[homeless]
            r = hashes.splitmix64(k + np.uint64(0x9E37 + rnd))
            use_b2 = (r & np.uint64(1)).astype(bool)
            tb = np.where(use_b2, b2[homeless], b1[homeless])
            lane = ((r >> np.uint64(1)) % np.uint64(SLOTS)).astype(np.int64)
            slot = tb * SLOTS + lane
            uniq, first = np.unique(slot, return_index=True)
            winners = homeless[first]
            evicted = owner[uniq]
            owner[uniq] = winners
            choice[uniq] = use_b2[first].astype(np.uint8)
            keep = np.ones(homeless.size, dtype=bool)
            keep[first] = False
            homeless = np.concatenate([homeless[keep], evicted[evicted >= 0]])
        if homeless.size:
            return False
        self.owner, self.choice = owner, choice
        self._finalize()
        return True

    def _try_build_native(self, nb: int, max_walk: int = 500):
        """Scalar C cuckoo insert with random-walk eviction
        (native/src/sortops.cpp btpu_cuckoo_place) — the slot layout is a
        derived structure, so any valid placement is equivalent; the C
        path replaces ~15 full-array numpy passes per greedy round.
        Returns True/False (placed / needs growth), or None when the
        native library is unavailable."""
        from ..native import get_lib

        lib = get_lib()
        if lib is None or not hasattr(lib, "btpu_cuckoo_place"):
            return None
        owner = np.empty(nb * SLOTS, dtype=np.int64)
        choice = np.zeros(nb * SLOTS, dtype=np.uint8)
        h = np.ascontiguousarray(self._h, dtype=np.uint64)
        rc = lib.btpu_cuckoo_place(
            h.ctypes.data, self.n, nb, int(BSALT), max_walk,
            owner.ctypes.data, choice.ctypes.data,
        )
        if rc != 0:
            return False
        self.owner, self.choice = owner, choice
        self._finalize()
        return True

    def _finalize(self):
        occ = self.owner >= 0
        self.occ_mask = occ
        slot_of = np.full(self.n, -1, dtype=np.int64)
        if self.n:
            slot_of[self.owner[occ]] = np.nonzero(occ)[0]
        self.slot_of = slot_of
        self.max_scan = 2  # by construction

    # -- memory -------------------------------------------------------------
    def trim(self):
        """Free the cuckoo-layout build intermediates (~32 B/slot +
        ~24 B/key: _h, owner, choice, occ_mask, slot_of) plus the cached
        probe arrays.  Everything is lazily REBUILT on next use by
        re-running the deterministic placement at the same nb
        (_ensure_layout), so all APIs keep working — this only trades a
        one-time rebuild for classify-time memory.  The classifier calls
        it after uploading its device arrays: these intermediates were
        ~40% of the sustained-stream RSS high-water (the reference's
        khash image keeps nothing beyond the live table either,
        util.h:281-372)."""
        self._h = None
        self.owner = None
        self.choice = None
        self.occ_mask = None
        self.slot_of = None
        self._np_arrays = None
        self._jax_arrays = None

    def _ensure_layout(self):
        if self.owner is None:
            self._h = hashes.splitmix64(self.keys_sorted)
            if not self._try_build(self.nb):
                raise RuntimeError(
                    "cuckoo re-placement failed at the original nb"
                )

    # -- derived probe arrays ----------------------------------------------
    def _encode_slots(self, vals_aligned: np.ndarray,
                      uniq: Optional[np.ndarray] = None,
                      allow_inline: bool = True):
        """(slots (nb, SLOTS) u64, vals, inline) for values aligned to
        keys_sorted.

        ``uniq`` optionally provides a shared sorted unique-values array
        (hash-sharded tables encode every shard against one global value
        table so val_idx is consistent across shards).
        ``allow_inline=False`` forces the flat slot-indexed value array
        (shards loaded independently per process cannot agree on a global
        unique-values table)."""
        self._ensure_layout()
        vals_aligned = np.asarray(vals_aligned)
        v64 = vals_aligned.astype(np.uint64)
        if uniq is None:
            uniq = np.unique(v64) if self.n else np.zeros(1, np.uint64)
        if uniq.size == 0:
            uniq = np.zeros(1, np.uint64)
        inline = allow_inline and uniq.size <= (1 << self.vbits)
        occ = self.occ_mask
        words = np.zeros(self.nb * SLOTS, dtype=np.uint64)
        if self.n:
            own = self.owner[occ]
            q = self._h[own] >> np.uint64(self.lgnb)
            w = (
                _OCC
                | (self.choice[occ].astype(np.uint64) << np.uint64(62))
                | (q << np.uint64(self.vbits))
            )
            if inline:
                validx = np.searchsorted(uniq, v64[own]).astype(np.uint64)
                w = w | validx
            words[occ] = w
        slots = words.reshape(self.nb, SLOTS)
        if inline:
            return slots, uniq, True
        flat = np.zeros(self.nb * SLOTS, dtype=np.uint64)
        if self.n:
            flat[occ] = v64[self.owner[occ]]
        return slots, flat.reshape(self.nb, SLOTS), False

    def arrays_np(self, new_vals_sorted: Optional[np.ndarray] = None):
        if new_vals_sorted is None:
            if self._np_arrays is None:
                self._np_arrays = self._encode_slots(self.vals_sorted)
            return self._np_arrays
        return self._encode_slots(new_vals_sorted)

    def device_arrays(self, new_vals_sorted: Optional[np.ndarray] = None):
        import jax.numpy as jnp

        if new_vals_sorted is None and self._jax_arrays is not None:
            return self._jax_arrays
        slots, vals, inline = self.arrays_np(new_vals_sorted)
        out = (jnp.asarray(slots), jnp.asarray(vals), inline)
        if new_vals_sorted is None:
            self._jax_arrays = out
        return out

    # -- probes -------------------------------------------------------------
    def _expected(self, q, xp):
        """(e1, e2, vmask): expected slot words per choice."""
        vmask = xp.uint64((1 << self.vbits) - 1)
        base = xp.uint64(1 << 63) | (q << xp.uint64(self.vbits))
        return base, base | xp.uint64(1 << 62), vmask

    def probe_np(self, queries: np.ndarray,
                 arrays=None) -> Tuple[np.ndarray, np.ndarray]:
        q_in = np.asarray(queries, dtype=np.uint64)
        slots, vals, inline = arrays or self.arrays_np()
        h = hashes.splitmix64(q_in)
        b1, q, b2 = self._split(h, self.lgnb)
        e1, e2, vmask = self._expected(q, np)
        lane = np.arange(SLOTS, dtype=np.int64)
        found = np.zeros(q_in.shape, dtype=bool)
        val = np.zeros(q_in.shape, dtype=np.uint64)
        for b, e in ((b1, e1), (b2, e2)):
            b = b.astype(np.int64)
            row = slots[b]
            m = (row & ~vmask) == e[..., None]
            hit = m.any(-1)
            if inline:
                vi = ((row & vmask) * m).sum(-1)
                v = vals[np.minimum(vi, vals.size - 1).astype(np.int64)]
            else:
                pos = ((b[..., None] * SLOTS + lane) * m).sum(-1)
                v = vals.reshape(-1)[pos]
            val = np.where(hit & ~found, v, val)
            found |= hit
        if self.vals_sorted.dtype != np.uint64:
            val = val.astype(self.vals_sorted.dtype)
        return val, found

    def probe_device(self, queries, arrays=None,
                     want_idx: bool = False) -> Tuple:
        """queries: (...,) uint64 jnp array -> (vals u64, found).  Two 32B
        row gathers + one small value gather."""
        slots, vals, inline = arrays or self.device_arrays()
        return probe_slots_device(
            queries, slots, vals, inline, self.lgnb, self.vbits, want_idx
        )

    # -- dict-style host access (tests / small tools) ---------------------
    def lookup(self, key: int):
        i = int(np.searchsorted(self.keys_sorted, np.uint64(key)))
        if i < self.n and self.keys_sorted[i] == np.uint64(key):
            return self.vals_sorted[i]
        return None

    def __len__(self):
        return self.n


def probe_slots_device(queries, slots, vals, inline: bool, lgnb: int,
                       vbits: int, want_idx: bool = False):
    """Probe a quotient-cuckoo slot array on device: (..., ) u64 queries
    -> (packed vals u64, found bool).  Two 32B row gathers + one small
    value gather.  Standalone so hash-sharded sub-tables (which share one
    geometry but live inside shard_map) probe with the exact same math as
    KmerTable.probe_device.

    want_idx=True additionally returns ``sel`` — in inline mode the index
    into the unique-values table (the dictionary index the byte-light
    compact fetch ships instead of 32-bit taxids), already computed as a
    probe by-product; in flat mode the matched slot position (not a
    dictionary)."""
    import jax.numpy as jnp

    h = hashes.splitmix64(queries)
    b1, q, b2 = KmerTable._split(h, lgnb, xp=jnp)
    vmask = jnp.uint64((1 << vbits) - 1)
    base = jnp.uint64(1 << 63) | (q << jnp.uint64(vbits))
    e1, e2 = base, base | jnp.uint64(1 << 62)
    lane = jnp.arange(SLOTS, dtype=jnp.uint32)
    found = jnp.zeros(queries.shape, dtype=bool)
    sel = jnp.zeros(queries.shape, dtype=jnp.uint32)  # val index/slot pos
    for b, e in ((b1, e1), (b2, e2)):
        bi = b.astype(jnp.int32)
        row = slots[bi]
        m = (row & ~vmask) == e[..., None]
        hit = jnp.any(m, axis=-1)
        if inline:
            s = jnp.sum(jnp.where(m, (row & vmask).astype(jnp.uint32), 0), -1)
        else:
            pos = bi[..., None].astype(jnp.uint32) * SLOTS + lane
            s = jnp.sum(jnp.where(m, pos, 0), -1)
        sel = jnp.where(hit & ~found, s, sel)
        found = found | hit
    flat_vals = vals.reshape(-1)
    val = flat_vals[sel.astype(jnp.int32)]
    val = jnp.where(found, val, 0)
    if want_idx:
        return val, found, jnp.where(found, sel, 0)
    return val, found


def shard_owner(kmers, ndb: int, xp=np):
    """Hash-prefix shard owner of each kmer, in [0, ndb), for any ndb
    (fixed-point range partition of splitmix64's top 32 bits — the
    'prefix-sharded by leading hash bits' policy of SURVEY §2.10).  The
    owner bits are disjoint from the b1 bucket bits (low lgnb), so
    within-shard bucket balance is unaffected."""
    h = hashes.splitmix64(kmers)
    return (((h >> xp.uint64(32)) * xp.uint64(ndb)) >> xp.uint64(32)).astype(
        xp.int32
    )


class HashShardedTable:
    """ndb independent quotient-cuckoo sub-tables partitioned by hash
    prefix — the all_to_all-routed replacement for range-sharding one
    global table.

    Every key lives on exactly one shard (owner = shard_owner(key, ndb));
    a query is routed to its owner and probed there with the standard
    dual-gather, so N chips deliver N chips of gather throughput (each
    query's two row gathers happen on ONE rank), unlike the psum design
    where every rank gathers rows for all of its dp-group's queries
    (the reference's full-speed shared khash property,
    /root/reference/include/bonsai/classifier.h:133).

    All shards are built with a common bucket count nb (hence common lgnb
    / vbits / expected-word math), so their slot arrays stack into one
    (ndb, nb, SLOTS) u64 array shardable along a 'db' mesh axis."""

    def __init__(self, table: KmerTable, ndb: int):
        if ndb < 1:
            raise ValueError("ndb must be >= 1")
        self.ndb = ndb
        keys, vals = table.keys_sorted, table.vals_sorted
        owner = shard_owner(keys, ndb)
        # subsets of a sorted array stay sorted: each shard's keys_sorted
        # invariant holds by construction
        self.parts: List[np.ndarray] = [
            np.nonzero(owner == s)[0] for s in range(ndb)
        ]
        nmax = max(max((p.size for p in self.parts), default=0), 1)
        nb = max(_next_pow2(int(np.ceil(nmax / (SLOTS * MAX_LOAD)))), 4)
        while True:
            shards = [
                KmerTable(keys[p], vals[p], min_nb=nb) for p in self.parts
            ]
            got = max(s.nb for s in shards)
            if got == nb:
                break
            nb = got  # a shard needed growth: rebuild all at the same nb
        self.shards = shards
        self.nb = nb
        self.lgnb = shards[0].lgnb
        self.vbits = shards[0].vbits
        self.n = table.n

    def arrays_np(self, vals_aligned: np.ndarray):
        """(slots (ndb, nb, SLOTS) u64, vals, inline) for values aligned
        to the parent table's keys_sorted.  In inline mode ``vals`` is ONE
        global unique-values array (replicated across ranks); otherwise a
        stacked (ndb, nb, SLOTS) u64 value array sharded with the slots."""
        v64 = np.asarray(vals_aligned).astype(np.uint64)
        uniq = np.unique(v64) if v64.size else np.zeros(1, np.uint64)
        if uniq.size == 0:
            uniq = np.zeros(1, np.uint64)
        slots_l, vals_l, inline = [], [], None
        for shard, p in zip(self.shards, self.parts):
            s, v, i = shard._encode_slots(v64[p], uniq=uniq)
            if inline is None:
                inline = i
            assert i == inline  # same vbits + same uniq => same mode
            slots_l.append(s)
            vals_l.append(v)
        if not self.shards:
            return (np.zeros((0, 0, SLOTS), np.uint64), uniq, True)
        slots = np.stack(slots_l)
        vals = uniq if inline else np.stack(vals_l)
        return slots, vals, inline


class ScoreMap:
    """score::Hash adapter: phase-1 (kmer -> packed u64 score) map used as a
    minimizer ordering (encoder.h:61-74, implemented as intended — see
    core/encoder.py docstring)."""

    def __init__(self, table: KmerTable):
        self.table = table

    def lookup_scores(self, kmers):
        if isinstance(kmers, np.ndarray):
            xp = np
            val, found = self.table.probe_np(kmers)
        else:
            import jax.numpy as xp

            val, found = self.table.probe_device(kmers)
        # missing kmers should not occur (phase-1 covers phase-2 input);
        # give them the worst score so they never win a window.
        return xp.where(found, val.astype(xp.uint64), xp.uint64((1 << 64) - 1))
