"""Multi-device classification and encoding under shard_map.

Sharding policy (SURVEY §2.10 / §5 "Distributed communication backend"):

* reads are data-parallel along mesh axis 'dp';
* the DB table is either replicated (small DB) or sharded along axis
  'db', with two routing strategies:

  - route="a2a" (default when ndb > 1): the table is HASH-PREFIX
    sharded (db.table split into ndb independent sub-tables by
    shard_owner(key), db/table.py); reads shard over BOTH axes, each
    device bucketizes its queries by owner rank, all_to_all routes them
    over 'db', the owner probes 1/ndb of the stream with the standard
    dual-gather, and a second all_to_all returns packed results.  Per-
    chip gather volume is flat in ndb — N chips deliver N chips of
    probe throughput, preserving the reference's full-speed shared-
    khash property (/root/reference/include/bonsai/classifier.h:133).
    Exactness under arbitrary bucket skew (e.g. low-complexity reads
    whose kmers all hash to one owner) comes from a while_loop that
    re-routes capacity overflow in further rounds; the common case is
    one round.

  - route="psum": rank s owns a contiguous range of the ONE global
    table's buckets [s*nb/ndb, (s+1)*nb/ndb).  Queries replicate along
    'db' (reads shard only over 'dp'); each rank probes its local range
    and results merge with one psum ('db' — each key exists on exactly
    one rank, so psum(val * found) is exact).  No routing traffic, but
    every rank gathers rows for ALL of its dp-group's queries, so
    per-chip gather work grows ndb-fold; kept for small meshes and for
    comparison.

* long contigs in DB build shard the *sequence* axis along 'sp' with a
  (w-1)-base halo pulled from the right neighbor via ppermute — the
  blockwise-with-halo analog of ring attention for rolling encoders.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _pad_rows_pow2(nb: int, ndb: int) -> int:
    return (nb + ndb - 1) // ndb


class ShardedClassifier:
    """Device-mesh classifier: encode + sharded probe + resolve.

    Wraps the same math as classify.pipeline.Classifier but expressed as a
    shard_map over a Mesh with axes ('dp', 'db')."""

    def __init__(self, db, tree, mesh, canonicalize: bool = True,
                 input_type=None, route: str = "auto",
                 capacity_factor: Optional[float] = None,
                 emit_all: bool = False, emit_kraken: bool = True,
                 emit_fastq: bool = False):
        import os

        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..core.alphabet import InputType
        from ..core.encoder import BatchEncoder
        from ..core.spacer import Spacer

        input_type = InputType.DNA if input_type is None else input_type
        self.mesh = mesh
        self.db = db
        self.tree = tree
        self.sp = Spacer(db.k, db.k, db.gaps)
        self.enc = BatchEncoder(self.sp, canonicalize, "lex", input_type)
        self.ndb = mesh.shape.get("db", 1)
        self.ndp = mesh.shape.get("dp", 1)
        if route == "auto":
            route = "a2a" if self.ndb > 1 else "psum"
        if route not in ("a2a", "psum"):
            raise ValueError(f"unknown route {route!r}")
        self.route = route
        self.capacity_factor = float(
            capacity_factor
            if capacity_factor is not None
            else os.environ.get("BONSAI_TPU_A2A_CF", 1.05)
        )

        table = db.table
        compact_vals = tree.compact(table.vals_sorted, missing_ok=True)
        # packed payload: orig taxid high u32, compact idx low u32
        packed = (
            table.vals_sorted.astype(np.uint64) << np.uint64(32)
        ) | compact_vals.astype(np.uint32).astype(np.uint64)
        shard_db = NamedSharding(mesh, P("db"))
        repl = NamedSharding(mesh, P())
        multiproc = any(
            d.process_index != jax.process_index()
            for d in mesh.devices.flat
        )

        def gput(arr, sharding):
            if multiproc:
                a = np.asarray(arr)
                return jax.make_array_from_callback(
                    a.shape, sharding, lambda idx: a[idx]
                )
            return jax.device_put(jnp.asarray(arr), sharding)

        if route == "a2a" and self.ndb > 1:
            from ..db.table import HashShardedTable

            # routed responses pack (found:1 | compact:31) in the low word
            assert len(tree.device_arrays()["tin"]) < (1 << 31)
            self._htab = HashShardedTable(table, self.ndb)
            slots, vals, inline = self._htab.arrays_np(packed)
            self._inline = inline
            self._slots = gput(slots, shard_db)
            self._vals = gput(vals, repl if inline else shard_db)
        else:
            self._htab = None
            nb = table.nb
            rows = _pad_rows_pow2(nb, self.ndb) * self.ndb
            pad = rows - nb
            slots, vals, inline = table.arrays_np(packed)
            if pad:
                # pad rows are all-zero slot words: can never match
                # (occupied bit unset, see table.py)
                z = np.zeros((pad, slots.shape[1]), dtype=slots.dtype)
                slots = np.concatenate([slots, z], axis=0)
                if not inline:
                    vals = np.concatenate([vals, z], axis=0)
            self._inline = inline
            self._slots = gput(slots, shard_db)
            # unique-values table is tiny -> replicated; flat vals shard
            # with their slots
            self._vals = gput(vals, repl if inline else shard_db)
            self._rows_per_shard = rows // self.ndb
        # dictionary mode (see classify/pipeline.py): inline value tables
        # of <= 2^16 entries let the compact fetch ship 16-bit value
        # indices instead of 32-bit taxids; the index is global across
        # shards because all shards encode against ONE unique-values array
        self._uniq_host = None
        if inline and np.asarray(vals).size <= 0xFFFF:
            self._uniq_host = (
                np.asarray(vals) >> np.uint64(32)
            ).astype(np.uint32)
        self._n_distinct = int(np.unique(compact_vals).size)
        self._tax = {
            k: gput(np.asarray(v), repl)
            for k, v in tree.device_arrays().items()
        }
        self._init_host(input_type, emit_all, emit_kraken, emit_fastq)

    def _init_host(self, input_type, emit_all, emit_kraken, emit_fastq):
        """Host-pipeline state shared with the single-chip Classifier
        (its _finish_batch/_write_result/process_dataset run unchanged
        against this object)."""
        from ..core.alphabet import InputType, alphabet_of

        self.emit_all = emit_all
        self.emit_kraken = emit_kraken
        self.emit_fastq = emit_fastq
        self.lut = alphabet_of(InputType(input_type)).lut
        self.max_runs = int(os.environ.get("BONSAI_TPU_MAX_RUNS", 8))
        self._overflow_batches = 0
        self._overflow_bump_after = 3
        self._fns = {}
        # Classifier._finish_batch's adaptive bump only touches max_runs;
        # _dispatch_prepared revalidates its cached (fn, maxr) against it.
        self._step_cache = self._fns
        self.n_classified = 0
        self.n_unclassified = 0

    def _build_fn(self, paired: bool = False, compact: bool = False,
                  maxr: Optional[int] = None, with_n: str = "mask",
                  lproc: Optional[int] = None):
        if self.route == "a2a" and self.ndb > 1:
            return self._build_fn_a2a(paired, compact, maxr, with_n, lproc)
        return self._build_fn_psum(paired, compact, maxr, with_n, lproc)

    def _wrap_steps(self, core, compact: bool, spec0, table_specs,
                    maxr: Optional[int] = None, with_n: str = "mask",
                    lproc: Optional[int] = None):
        """shard_map a route's core into either the raw 6-tuple step
        (tests / step()) or the compact (RLE + full) step used by the
        host CLI pipeline — the SAME byte-light output layout and 2-bit
        packed upload as the single-chip classifier
        (classify/pipeline.py build_step_outputs / unpack_2bit)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..classify.pipeline import build_step_outputs, unpack_2bit

        mesh = self.mesh
        maxr = self.max_runs if maxr is None else maxr
        dict16 = compact and self._uniq_host is not None
        dict_size = len(self._uniq_host) if dict16 else None

        if compact:
            def finish_local(codes, lengths, slots, vals):
                if lproc is not None and lproc < codes.shape[1]:
                    codes = codes[:, :lproc]
                lengths = lengths.astype(jnp.int32)  # may arrive u16
                taxon, vo, hit, valid, valid1 = core(
                    codes, lengths, slots, vals
                )
                taxa = jnp.where(hit, vo, 0).astype(jnp.uint32)
                return build_step_outputs(
                    taxon.astype(jnp.uint32), taxa, hit, valid,
                    valid1.astype(jnp.uint32), maxr, dict_size=dict_size,
                )

            if with_n == "mask":
                def local_step(pcodes, nmask, lengths, slots, vals):
                    return finish_local(
                        unpack_2bit(pcodes, nmask), lengths, slots, vals
                    )

                in_specs = (spec0, spec0, spec0) + table_specs
            else:  # "none" (sparse-N is single-chip only, _sparse_n_ok)
                def local_step(pcodes, lengths, slots, vals):
                    return finish_local(
                        unpack_2bit(pcodes), lengths, slots, vals
                    )

                in_specs = (spec0, spec0) + table_specs
            fn = jax.shard_map(
                local_step, mesh=mesh, in_specs=in_specs,
                out_specs=(spec0, spec0),
            )
            return jax.jit(fn)

        def local_step(codes, lengths, slots, vals):
            taxon, vo, hit, valid, valid1 = core(codes, lengths, slots, vals)
            miss = valid & ~hit
            return (
                taxon,
                jnp.where(hit, vo, 0),
                hit,
                miss.sum(-1).astype(jnp.int32),
                valid.sum(-1).astype(jnp.int32),
                valid1,
            )

        fn = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(spec0, spec0) + table_specs,
            out_specs=(spec0,) * 6,
        )
        return jax.jit(fn)

    def _build_fn_a2a(self, paired: bool = False, compact: bool = False,
                      maxr: Optional[int] = None, with_n: str = "mask",
                      lproc: Optional[int] = None):
        """all_to_all-routed probe over hash-prefix sub-tables.

        Reads shard over BOTH mesh axes; each device encodes its own
        reads, routes each valid query to its owner rank over 'db',
        probes the routed stream locally, and routes packed results back.
        Per-chip row-gather volume per round = 2 * ndb * cap ~=
        2 * capacity_factor * Q_local — flat in ndb (see
        gather_rows_per_step)."""
        import jax
        import jax.numpy as jnp
        shard_map = jax.shard_map
        from jax.sharding import PartitionSpec as P

        from ..classify.resolve import resolve_batch
        from ..db.table import probe_slots_device, shard_owner

        enc = self.enc
        mesh = self.mesh
        ndb = self.ndb
        lgnb, vbits = self._htab.lgnb, self._htab.vbits
        inline = self._inline
        tax = self._tax
        cf = self.capacity_factor
        # compact steps ship the probe's global value index in the
        # response word instead of the 32-bit taxid (dictionary mode)
        dict16 = compact and self._uniq_host is not None
        ndist = self._n_distinct

        U32 = jnp.uint64(0xFFFFFFFF)
        LOW31 = jnp.uint64(0x7FFFFFFF)

        def routed_probe(kq, vq, slots, vals):
            """kq (Q,) u64 queries, vq (Q,) validity ->
            (vc compact-idx i32, vo orig-taxid u32, found bool)."""
            Q = kq.shape[0]
            owner = shard_owner(kq, ndb, xp=jnp)
            cap = max(int(np.ceil(Q / ndb * cf)), 1)
            DUMP = ndb * cap
            iota = jnp.arange(Q, dtype=jnp.uint64)
            SENT = jnp.uint64(0xFFFFFFFFFFFFFFFF)

            def body(state):
                done, res, _ = state
                pending = ~done
                # group pending queries by owner, preserving index order;
                # kq rides the sort as a second operand so the sorted
                # queries need no Q-sized gather (round-5 a2a stamp: the
                # dual-operand sort costs the same as sort+gather minus
                # the gather)
                key = jnp.where(
                    pending,
                    (owner.astype(jnp.uint64) << jnp.uint64(32)) | iota,
                    SENT,
                )
                skey, skq = jax.lax.sort((key, kq), num_keys=1)
                sidx = (skey & U32).astype(jnp.int32)
                # owner o's run spans [seg[o], seg[o+1]) in the sorted
                # array (SENT sorts last, so valid entries form a
                # prefix ordered by owner); seg boundaries come from
                # ndb+1 binary searches into the monotone sorted owner
                # column (SENT rows read 0xFFFFFFFF)
                sowner_u = (skey >> jnp.uint64(32)).astype(jnp.uint32)
                seg = jnp.searchsorted(
                    sowner_u, jnp.arange(ndb + 1, dtype=jnp.uint32)
                ).astype(jnp.int32)
                # send frame (ndb, cap): owner o's r-th query sits at
                # sorted position seg[o] + r.  Segment starts/ends enter
                # by BROADCAST (no per-row gather from seg), and the
                # send key + originating query index come from ONE
                # row gather out of a (Q, 2) matrix — the round-5 stamp
                # measured this formulation at 41 ns/query vs 63 for
                # the per-array-gather one.  Rows past a segment's end
                # carry stale keys; their probe responses are never
                # read (slotq below only maps valid rows).
                src2 = (
                    seg[:ndb, None]
                    + jnp.arange(cap, dtype=jnp.int32)[None, :]
                ).reshape(DUMP)
                end2 = jnp.broadcast_to(
                    seg[1:, None], (ndb, cap)
                ).reshape(DUMP)
                valid_j = src2 < end2
                src_safe = jnp.minimum(src2, Q - 1)
                both = jnp.stack(
                    [skq, sidx.astype(jnp.uint64)], axis=1
                )
                g = both[src_safe]  # (DUMP, 2): [query key, query idx]
                send = g[:, 0]
                qidx_j = g[:, 1].astype(jnp.int32)
                # where did query i go?  (DUMP = nowhere this round)
                jdump = jnp.arange(DUMP, dtype=jnp.int32)
                slotq = (
                    jnp.full((Q,), DUMP, jnp.int32)
                    .at[jnp.where(valid_j, qidx_j, Q)]
                    .set(jdump, mode="drop")
                )
                recv = jax.lax.all_to_all(send, "db", 0, 0, tiled=True)
                if dict16:
                    val, fnd, sel = probe_slots_device(
                        recv, slots, vals, inline, lgnb, vbits,
                        want_idx=True,
                    )
                    # response word: value index | found | compact idx
                    resp = (
                        (sel.astype(jnp.uint64) << jnp.uint64(32))
                        | (fnd.astype(jnp.uint64) << jnp.uint64(31))
                        | (val & LOW31)
                    )
                else:
                    val, fnd = probe_slots_device(
                        recv, slots, vals, inline, lgnb, vbits
                    )
                    # response word: orig taxid | found | compact idx
                    resp = (
                        (val & ~U32)
                        | (fnd.astype(jnp.uint64) << jnp.uint64(31))
                        | (val & LOW31)
                    )
                back = jax.lax.all_to_all(resp, "db", 0, 0, tiled=True)
                newly = slotq < DUMP
                got = back[jnp.minimum(slotq, DUMP - 1)]
                res = jnp.where(newly, got, res)
                done = done | newly
                # all devices agree on the trip count (overflow rounds are
                # rare; an idle round for a finished group sends zeros)
                rem = jax.lax.psum(
                    jnp.sum(~done, dtype=jnp.int32), ("dp", "db")
                )
                return done, res, rem

            done0 = ~vq
            # the carry varies per device: mark it so (shard_map vma typing)
            res0 = jax.lax.pcast(
                jnp.zeros((Q,), jnp.uint64), ("dp", "db"), to="varying"
            )
            rem0 = jax.lax.psum(jnp.sum(~done0, dtype=jnp.int32), ("dp", "db"))
            done, res, _ = jax.lax.while_loop(
                lambda st: st[2] > 0, body, (done0, res0, rem0)
            )
            vc = (res & LOW31).astype(jnp.int32)
            vo = (res >> jnp.uint64(32)).astype(jnp.uint32)
            found = ((res >> jnp.uint64(31)) & jnp.uint64(1)) != 0
            return vc, vo, found

        def core(codes, lengths, slots3, vals):
            slots = slots3[0]  # local view (1, nb, SLOTS) -> (nb, SLOTS)
            vals_l = vals if inline else vals[0]
            em = enc.emissions(codes, lengths)
            kmers, valid = em.values, em.mask
            b, Pw = kmers.shape
            if Pw:
                vc, vo, found = routed_probe(
                    kmers.reshape(-1), valid.reshape(-1), slots, vals_l
                )
                vc = vc.reshape(b, Pw)
                vo = vo.reshape(b, Pw)
                found = found.reshape(b, Pw)
            else:
                vc = jnp.zeros((b, 0), jnp.int32)
                vo = jnp.zeros((b, 0), jnp.uint32)
                found = jnp.zeros((b, 0), bool)
            hit = valid & found
            valid1 = valid.sum(-1).astype(jnp.int32)
            if paired:
                # adjacent rows are mates of one pair (the caller keeps
                # the per-shard row count even)
                B, P_ = hit.shape
                hit = hit.reshape(B // 2, 2 * P_)
                valid = valid.reshape(B // 2, 2 * P_)
                vc = vc.reshape(B // 2, 2 * P_)
                vo = vo.reshape(B // 2, 2 * P_)
                valid1 = valid1[0::2]
            cidx = jnp.where(hit, vc, 0)
            taxon_c = resolve_batch(cidx, hit, tax, n_distinct=ndist)
            taxon = tax["tax_ids"][taxon_c]
            return taxon, vo, hit, valid, valid1

        both = ("dp", "db")
        return self._wrap_steps(
            core, compact, spec0=P(both),
            table_specs=(P("db"), P() if inline else P("db")), maxr=maxr,
            with_n=with_n, lproc=lproc,
        )

    def _build_fn_psum(self, paired: bool = False, compact: bool = False,
                       maxr: Optional[int] = None, with_n: str = "mask",
                       lproc: Optional[int] = None):
        import jax
        import jax.numpy as jnp
        shard_map = jax.shard_map
        from jax.sharding import PartitionSpec as P

        from ..core import hashes
        from ..core import hashes as hsh
        from ..db.table import SLOTS
        from ..classify.resolve import resolve_batch

        enc = self.enc
        table = self.db.table
        mesh = self.mesh
        rows_per_shard = self._rows_per_shard
        lgnb = table.lgnb
        inline = self._inline
        tax = self._tax
        split = type(table)._split
        expected = table._expected
        dict16 = compact and self._uniq_host is not None
        ndist = self._n_distinct

        def probe_local(kmers, slots, vals):
            """Probe the local bucket range; misses for foreign buckets."""
            db_rank = jax.lax.axis_index("db")
            row0 = db_rank.astype(jnp.int64) * rows_per_shard
            h = hsh.splitmix64(kmers)
            b1, q, b2 = split(h, lgnb, xp=jnp)
            e1, e2, vmask = expected(q, jnp)
            lane = jnp.arange(SLOTS, dtype=jnp.uint32)
            found = jnp.zeros(kmers.shape, dtype=bool)
            sel = jnp.zeros(kmers.shape, dtype=jnp.uint32)
            for b, e in ((b1, e1), (b2, e2)):
                local = b.astype(jnp.int64) - row0
                mine = (local >= 0) & (local < rows_per_shard)
                li = jnp.clip(local, 0, rows_per_shard - 1).astype(jnp.int32)
                row = slots[li]
                m = ((row & ~vmask) == e[..., None]) & mine[..., None]
                hit = jnp.any(m, axis=-1)
                if inline:
                    s = jnp.sum(
                        jnp.where(m, (row & vmask).astype(jnp.uint32), 0), -1
                    )
                else:
                    pos = li[..., None].astype(jnp.uint32) * SLOTS + lane
                    s = jnp.sum(jnp.where(m, pos, 0), -1)
                sel = jnp.where(hit & ~found, s, sel)
                found = found | hit
            packed = vals.reshape(-1)[sel.astype(jnp.int32)]
            packed = jnp.where(found, packed, 0)
            vc = (packed & jnp.uint64(0xFFFFFFFF)).astype(jnp.int32)
            if dict16:
                # sel indexes the ONE replicated unique-values table (and
                # is 0 for misses by construction of the where-sums above)
                vo = jnp.where(found, sel, 0)
            else:
                vo = (packed >> jnp.uint64(32)).astype(jnp.uint32)
            return vc, vo, found

        def core(codes, lengths, slots, vals):
            em = enc.emissions(codes, lengths)
            kmers, valid = em.values, em.mask
            vc, vo, found = probe_local(kmers, slots, vals)
            # merge across db shards: each key on exactly one shard
            vc = jax.lax.psum(vc * found, "db")
            vo = jax.lax.psum(jnp.where(found, vo, 0), "db")
            found = jax.lax.psum(found.astype(jnp.int32), "db") > 0
            hit = valid & found
            valid1 = valid.sum(-1).astype(jnp.int32)
            if paired:
                # adjacent rows are mates of one pair (shard-local: the
                # caller keeps the per-shard row count even)
                B, P_ = hit.shape
                hit = hit.reshape(B // 2, 2 * P_)
                valid = valid.reshape(B // 2, 2 * P_)
                vc = vc.reshape(B // 2, 2 * P_)
                vo = vo.reshape(B // 2, 2 * P_)
                valid1 = valid1[0::2]
            cidx = jnp.where(hit, vc, 0)
            taxon_c = resolve_batch(cidx, hit, tax, n_distinct=ndist)
            taxon = tax["tax_ids"][taxon_c]
            return taxon, vo, hit, valid, valid1

        return self._wrap_steps(
            core, compact, spec0=P("dp"),
            table_specs=(P("db"), P() if self._inline else P("db")),
            maxr=maxr, with_n=with_n, lproc=lproc,
        )

    def gather_rows_per_step(self, n_reads: int, read_len: int,
                             rounds: int = 1) -> int:
        """Analytic per-CHIP slot-row gather count for one step over a
        batch of n_reads reads of read_len bases (the probe's memory
        traffic).  In a2a mode this is flat in ndb — the design
        property the psum route lacks (its per-chip volume grows ndb-fold
        at fixed chip count)."""
        P = max(read_len - self.sp.c + 1, 0)
        if self.route == "a2a" and self.ndb > 1:
            q_local = -(-n_reads // (self.ndp * self.ndb)) * P
            cap = max(int(np.ceil(q_local / self.ndb * self.capacity_factor)), 1)
            return 2 * self.ndb * cap * rounds
        # psum: every db rank gathers 2 rows per query of its dp group
        return 2 * (-(-n_reads // self.ndp)) * P

    @classmethod
    def from_sharded_dir(cls, dirpath: str, tree, mesh,
                         canonicalize: bool = True, input_type=None,
                         capacity_factor: Optional[float] = None,
                         emit_all: bool = False, emit_kraken: bool = True,
                         emit_fastq: bool = False):
        """Multi-host constructor: each PROCESS loads only the shard files
        of its addressable 'db' ranks from a `build --shards N` directory
        (db/formats.py save_database_sharded) — DB load I/O and host RAM
        scale with 1/ndb per host.  The on-disk partition is the same
        hash-prefix ownership the a2a probe routes by, so a shard file
        maps 1:1 onto a 'db' rank.  Output is identical to the in-memory
        ShardedClassifier (route="a2a")."""
        import json

        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..core.alphabet import InputType
        from ..core.encoder import BatchEncoder
        from ..core.spacer import Spacer
        from ..db.formats import Database
        from ..db.table import SLOTS, KmerTable, MAX_LOAD, _next_pow2

        with open(os.path.join(dirpath, "manifest.json")) as fh:
            mf = json.load(fh)
        ndb = mesh.shape.get("db", 1)
        mfndb = mf["ndb"]
        if ndb >= 2 and mfndb > ndb and mfndb % ndb == 0:
            # more shard files than mesh ranks: each rank serves a GROUP
            # of consecutive shard files.  Valid because shard_owner is a
            # fixed-point RANGE partition of the hash prefix, so
            # owner_at(ndb) == owner_at(mfndb) // group exactly — rank r
            # owns precisely files [r*group, (r+1)*group).
            group = mfndb // ndb
        elif mfndb != ndb or ndb < 2:
            # incompatible split (or trivial mesh): merge-load instead
            from ..db.formats import load_database_sharded

            return cls(load_database_sharded(dirpath), tree, mesh,
                       canonicalize, input_type,
                       capacity_factor=capacity_factor, emit_all=emit_all,
                       emit_kraken=emit_kraken, emit_fastq=emit_fastq)
        else:
            group = 1
        self = cls.__new__(cls)
        self.mesh = mesh
        self.tree = tree
        self.ndb = ndb
        self.ndp = mesh.shape.get("dp", 1)
        self.route = "a2a"
        self.capacity_factor = float(
            capacity_factor
            if capacity_factor is not None
            else os.environ.get("BONSAI_TPU_A2A_CF", 1.05)
        )
        input_type = InputType.DNA if input_type is None else input_type
        k, w, gaps = mf["k"], mf["w"], mf["gaps"]
        self.db = Database(
            table=KmerTable(np.zeros(0, np.uint64), np.zeros(0, np.uint32)),
            k=k, w=w, gaps=gaps,
            canonicalize=mf.get("canonicalize", True),
            scheme=mf.get("scheme", "lex"), meta=mf.get("meta", {}),
        )
        self.sp = Spacer(k, k, gaps)
        self.enc = BatchEncoder(self.sp, canonicalize, "lex", input_type)

        # routed responses pack (found:1 | compact:31) in the low word —
        # same width limit the in-memory constructor asserts
        if len(tree.device_arrays()["tin"]) >= (1 << 31):
            raise ValueError(
                "taxonomy too large for the 31-bit compact index in the "
                "a2a response word"
            )
        # geometry must agree across processes without seeing foreign
        # shards: the saver negotiated (and recorded) the common bucket
        # count; older manifests fall back to deriving it from the counts
        if group > 1:
            # grouped ranks hold sums of consecutive shard counts — the
            # common nb comes from the largest GROUP (deterministic
            # across processes: shard_n is in the manifest)
            sums = [
                sum(mf["shard_n"][r * group:(r + 1) * group])
                for r in range(ndb)
            ]
            nmax = max(max(sums), 1)
            nb = max(_next_pow2(int(np.ceil(nmax / (SLOTS * MAX_LOAD)))), 4)
        elif "nb" in mf:
            nb = int(mf["nb"])
        else:
            nmax = max(max(mf["shard_n"]), 1)
            nb = max(_next_pow2(int(np.ceil(nmax / (SLOTS * MAX_LOAD)))), 4)
        lgnb = int(np.log2(nb))
        vbits = max(lgnb - 2, 0)
        # the saver records the DB's global distinct values, so independent
        # per-process loaders CAN agree on one shared unique-values table:
        # inline (replicated-dictionary) layout whenever it fits vbits
        uniq_packed = None
        u32v = None
        uf = mf.get("uniq_vals")
        if uf and os.path.exists(os.path.join(dirpath, uf)):
            uv = np.load(os.path.join(dirpath, uf))
            if uv.size and int(uv.max()) <= 0xFFFFFFFF and uv.size <= (
                1 << vbits
            ):
                u32v = uv.astype(np.uint32)
                uniq_packed = (
                    u32v.astype(np.uint64) << np.uint64(32)
                ) | tree.compact(u32v, missing_ok=True).astype(
                    np.uint32
                ).astype(np.uint64)
        cache = {}
        # per-rank memory images (bake_rank_images): when a matching
        # image dir exists, each rank mmaps its classify-ready slot
        # words instead of re-sorting + re-placing its shard group —
        # the per-rank analog of the single-device probe image
        # (util.h:281-372); stale geometry (different nb / dictionary
        # mode) is ignored
        from ..db import formats as _formats

        img_dir = os.path.join(
            dirpath, f"rankimg-db{ndb}-{_formats.tree_digest(tree)}"
        )
        img_ok = False
        if os.path.exists(os.path.join(img_dir, "meta.json")):
            import json as _json

            with open(os.path.join(img_dir, "meta.json")) as fh:
                im = _json.load(fh)
            img_ok = (
                im.get("nb") == nb
                and im.get("inline") == (uniq_packed is not None)
                and im.get("ndb") == ndb
            )
        self._rank_images_used = img_ok

        def shard_arrays(s: int):
            if s not in cache:
                from ..db.formats import read_database_arrays

                if img_ok:
                    slots = np.load(
                        os.path.join(img_dir, f"slots-{s:05d}.npy"),
                        mmap_mode="r",
                    )
                    flat = None
                    if uniq_packed is None:
                        flat = np.load(
                            os.path.join(img_dir, f"vals-{s:05d}.npy"),
                            mmap_mode="r",
                        )
                    cache[s] = (slots, flat)
                    return cache[s]
                ks, vs = [], []
                for f in range(s * group, (s + 1) * group):
                    _, kf, vf = read_database_arrays(
                        os.path.join(dirpath, mf["shards"][f])
                    )
                    ks.append(kf)
                    vs.append(vf)
                if group == 1:
                    keys, vals = ks[0], vs[0]
                else:
                    # files within a group interleave in key order
                    keys = np.concatenate(ks)
                    vals = np.concatenate(vs)
                    order = np.argsort(keys, kind="stable")
                    keys, vals = keys[order], vals[order]
                tbl = KmerTable(keys, vals, min_nb=nb)
                if tbl.nb != nb:
                    raise RuntimeError(
                        f"shard {s} required bucket growth ({tbl.nb} != "
                        f"{nb}); rebuild the sharded DB with more shards"
                    )
                packed = (
                    vals.astype(np.uint64) << np.uint64(32)
                ) | tree.compact(vals, missing_ok=True).astype(
                    np.uint32
                ).astype(np.uint64)
                if uniq_packed is not None:
                    slots, _, inline = tbl._encode_slots(
                        packed, uniq=uniq_packed
                    )
                    assert inline
                    cache[s] = (slots, None)
                else:
                    # no recorded dictionary (old layout): flat
                    # slot-indexed value array
                    slots, flat, inline = tbl._encode_slots(
                        packed, allow_inline=False
                    )
                    assert not inline
                    cache[s] = (slots, flat)
            return cache[s]

        shard_db = NamedSharding(mesh, P("db"))
        repl = NamedSharding(mesh, P())
        shape = (ndb, nb, SLOTS)
        # prefetch THIS process's ranks in a small thread pool: the heavy
        # parts (file read, radix sort, cuckoo walk) release the GIL, so
        # a dev host addressing many ranks loads them concurrently (on a
        # real multi-host run each host owns only its own ranks)
        my_ranks = sorted({
            int(idx[0].start or 0)
            for idx in shard_db.addressable_devices_indices_map(
                shape
            ).values()
        })
        if len(my_ranks) > 1:
            import concurrent.futures as _cf

            with _cf.ThreadPoolExecutor(min(4, len(my_ranks))) as pool:
                list(pool.map(shard_arrays, my_ranks))
        self._slots = jax.make_array_from_callback(
            shape, shard_db, lambda idx: shard_arrays(idx[0].start)[0][None]
        )
        if uniq_packed is not None:
            self._vals = jax.make_array_from_callback(
                uniq_packed.shape, repl, lambda idx: uniq_packed[idx]
            )
        else:
            self._vals = jax.make_array_from_callback(
                shape, shard_db,
                lambda idx: shard_arrays(idx[0].start)[1][None],
            )
        cache.clear()

        class _Geom:
            pass

        self._htab = _Geom()
        self._htab.nb = nb
        self._htab.lgnb = lgnb
        self._htab.vbits = vbits
        self._inline = uniq_packed is not None
        self._uniq_host = (
            u32v if u32v is not None and u32v.size <= 0xFFFF else None
        )
        self._n_distinct = (
            int(
                np.unique(
                    tree.compact(u32v, missing_ok=True)
                ).size
            )
            if u32v is not None
            else None
        )
        multiproc = any(
            d.process_index != jax.process_index()
            for d in mesh.devices.flat
        )
        tax = {}
        for kk, v in tree.device_arrays().items():
            a = np.asarray(v)
            if multiproc:
                tax[kk] = jax.make_array_from_callback(
                    a.shape, repl, lambda idx, a=a: a[idx]
                )
            else:
                tax[kk] = jax.device_put(jnp.asarray(a), repl)
        self._tax = tax
        self._init_host(input_type, emit_all, emit_kraken, emit_fastq)
        return self

    @property
    def _multiprocess(self) -> bool:
        import jax

        return any(
            d.process_index != jax.process_index()
            for d in self.mesh.devices.flat
        )

    def _to_global(self, x):
        """Host batch array -> device array.  Single-process: plain
        transfer (jit shards it).  Multi-process: every process holds the
        same full host batch; build the global Array from per-shard
        callbacks (jax.distributed runtime, SURVEY §2.10)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        if not self._multiprocess:
            return jnp.asarray(x)
        spec = P(("dp", "db")) if self.route == "a2a" else P("dp")
        sh = NamedSharding(self.mesh, spec)
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    def step(self, codes, lengths, paired: bool = False):
        if paired not in self._fns:
            self._fns[paired] = self._build_fn(paired)
        return self._fns[paired](
            self._to_global(codes),
            self._to_global(lengths),
            self._slots,
            self._vals,
        )

    # -- host-facing surface (mirrors classify.pipeline.Classifier) -------
    def classify_batch(self, batch, paired: bool = False):
        """ReadBatch -> BatchResult, padding B up to a multiple of the
        'dp' axis (and a pow2 bucket, to keep the compiled-shape set
        small).  For paired batches the per-shard row count stays even so
        mate pairs never straddle a shard boundary."""
        from ..classify.pipeline import BatchResult, Classifier

        n = len(batch.names)
        Bp = Classifier._bucket_batch(n)
        ranks = self.ndp * self.ndb if self.route == "a2a" else self.ndp
        mult = ranks * 2 if paired else ranks
        if Bp % mult:
            Bp = ((Bp + mult - 1) // mult) * mult
        codes, lengths = batch.codes, batch.lengths
        if Bp != n:
            codes = np.full((Bp, codes.shape[1]), -1, dtype=np.int8)
            codes[:n] = batch.codes
            lengths = np.zeros(Bp, dtype=np.int32)
            lengths[:n] = batch.lengths
        taxon, taxa, hit, n_missing, n_kmers, n_kmers1 = map(
            np.asarray, self.step(codes, lengths, paired)
        )
        R = n // 2 if paired else n
        taxon = taxon[:R]
        self.n_classified += int((taxon != 0).sum())
        self.n_unclassified += int((taxon == 0).sum())
        if paired:
            return BatchResult(
                names=batch.names[0::2], seqs=batch.seqs[0::2],
                quals=batch.quals[0::2] if batch.quals else None,
                lengths=batch.lengths[0::2], taxon=taxon, taxa=taxa[:R],
                hit_mask=hit[:R], n_missing=n_missing[:R].astype(np.int32),
                n_kmers=n_kmers[:R].astype(np.int32),
                n_kmers1=n_kmers1[:R].astype(np.int32),
                lengths2=batch.lengths[1::2], seqs2=batch.seqs[1::2],
                quals2=batch.quals[1::2] if batch.quals else None,
            )
        return BatchResult(
            names=batch.names, seqs=batch.seqs, quals=batch.quals,
            lengths=batch.lengths, taxon=taxon, taxa=taxa[:n],
            hit_mask=hit[:n], n_missing=n_missing[:n].astype(np.int32),
            n_kmers=n_kmers[:n].astype(np.int32),
            n_kmers1=n_kmers1[:n].astype(np.int32),
        )

    # -- host CLI pipeline (shared with the single-chip Classifier) -------
    def _batch_multiple(self, paired: bool) -> int:
        ranks = self.ndp * self.ndb if self.route == "a2a" else self.ndp
        return ranks * 2 if paired else ranks

    def _sparse_n_ok(self) -> bool:
        # sparse-N flat indices are batch-global; rows here are sharded
        # across devices, so fall back to the full bitmask channel
        return False

    def _bucket_batch(self, n: int) -> int:
        from ..classify.pipeline import Classifier

        return Classifier._bucket_batch(n)

    @staticmethod
    def pack_codes(codes, with_nmask: bool = True):
        from ..classify.pipeline import Classifier

        return Classifier.pack_codes(codes, with_nmask)

    def _to_device(self, x):
        return self._to_global(x)

    def _prepare_batch(self, batch, paired: bool = False):
        from ..classify.pipeline import Classifier

        return Classifier._prepare_batch(self, batch, paired)

    def _pack_batch_native(self, *args, **kwargs):
        from ..classify.pipeline import Classifier

        return Classifier._pack_batch_native(self, *args, **kwargs)

    def _dispatch_prepared(self, prep, paired: bool = False):
        """Device half of the shared host pipeline: run the compact
        (RLE + full) sharded step and start the device->host copy — the
        same transfer-light layout the single-chip pipeline fetches."""
        pcodes, naux, lengths, lproc, nmode = prep
        key = ("compact", paired, nmode, lproc)
        maxr = self.max_runs
        ent = self._fns.get(key)
        if ent is None or ent[1] != maxr:
            ent = (
                self._build_fn(paired, compact=True, maxr=maxr,
                               with_n=nmode, lproc=lproc),
                maxr,
            )
            self._fns[key] = ent
        fn, maxr = ent
        if nmode == "mask":
            compact, full = fn(
                pcodes, naux, lengths, self._slots, self._vals
            )
        else:
            compact, full = fn(pcodes, lengths, self._slots, self._vals)
        try:
            compact.copy_to_host_async()
        except (AttributeError, NotImplementedError):
            pass
        return compact, full, lproc, maxr

    def _dispatch_batch(self, batch, paired: bool = False):
        return self._dispatch_prepared(
            self._prepare_batch(batch, paired), paired
        )

    def _finish_batch(self, batch, out, paired: bool = False,
                      force_full: bool = False):
        from ..classify.pipeline import Classifier

        return Classifier._finish_batch(self, batch, out, paired, force_full)

    def _finish_arrays(self, *args, **kwargs):
        from ..classify.pipeline import Classifier

        return Classifier._finish_arrays(self, *args, **kwargs)

    def _write_result(self, out_fh, batch, out, is_paired):
        from ..classify.pipeline import Classifier

        return Classifier._write_result(self, out_fh, batch, out, is_paired)

    def process_dataset(self, path, out_fh, mate_path=None,
                        batch_size: int = 4096, profile: bool = False):
        """Classify a dataset over the mesh and write text output — the
        SAME pipelined host loop as the single-chip classifier (writer
        thread, async fetches, compact RLE transfers), byte-identical
        output.  Emit flags come from the constructor.  For
        jax.distributed runs use process_dataset_distributed (per-rank
        output files; fetching a global array on one controller is not
        possible across processes)."""
        from ..classify.pipeline import Classifier

        return Classifier.process_dataset(
            self, path, out_fh, mate_path=mate_path, batch_size=batch_size,
            profile=profile,
        )

    # -- multi-host per-rank I/O ------------------------------------------
    def process_dataset_distributed(self, path, out_dir: str,
                                    mate_path=None, batch_size: int = 4096):
        """Multi-host classify with PER-PROCESS output: every process
        dispatches the same sequence of global steps (the a2a/psum
        collectives span the whole mesh), but each process fetches,
        formats, and writes ONLY the result rows held by its own devices
        (jax.Array addressable_shards) — no host gather, output I/O
        scales with 1/nproc per host.

        Writes ``part-{pid:05d}.tsv`` plus a ``.idx`` sidecar of
        per-batch byte counts; ``merge_distributed_output(out_dir, fh)``
        reassembles the exact single-process byte stream (per batch,
        ranks concatenate in global row order).  Matches the reference's
        full-speed streaming emitter (classifier.h:296-337) at N hosts.

        The adaptive max_runs bump is disabled here: a per-process bump
        would recompile a different step on one process and deadlock the
        collectives; run-capacity overflow instead falls back to the
        (locally fetched) full positional shards per batch."""
        import json as _json

        import jax

        from ..classify.pipeline import BatchResult, Classifier
        from ..classify import output as out_mod
        from ..io import fastx

        pid = jax.process_index()
        os.makedirs(out_dir, exist_ok=True)
        part = os.path.join(out_dir, f"part-{pid:05d}.tsv")
        idx = []
        is_paired = mate_path is not None
        if is_paired and batch_size % 2:
            batch_size += 1
        n_rows_written = 0
        with open(part, "w", encoding="utf-8") as fh:
            for batch in fastx.batch_reads(
                path, self.lut, batch_size=batch_size, mate_path=mate_path
            ):
                out = self._dispatch_batch(batch, is_paired)
                compact_dev, full_dev, lproc, maxr = out
                n = len(batch.names)
                R = n // 2 if is_paired else n
                pieces = []  # [row_start, nbytes] per local shard
                seen = set()  # psum-route outputs replicate over 'db'
                for shard in sorted(
                    compact_dev.addressable_shards,
                    key=lambda s: s.index[0].start or 0,
                ):
                    # psum-route outputs are replicated over 'db': only
                    # replica 0 (a GLOBAL id) writes a row block, so the
                    # same rows can never land in two processes' parts
                    if shard.replica_id != 0:
                        continue
                    rsl = shard.index[0]
                    r0 = rsl.start or 0
                    r1 = min(rsl.stop if rsl.stop is not None else R, R)
                    if r1 <= r0 or r0 in seen:
                        continue
                    seen.add(r0)
                    cm = np.asarray(shard.data)[: r1 - r0]
                    sub = self._slice_batch(batch, r0, r1, is_paired)

                    def fetch_full(r0=r0, r1=r1, rsl=rsl):
                        for fs in full_dev.addressable_shards:
                            fsl = fs.index[0]
                            if (fsl.start or 0) == (rsl.start or 0):
                                return np.asarray(fs.data)[: r1 - r0]
                        raise RuntimeError("full shard not local")

                    res = Classifier._finish_arrays(
                        self, sub, cm, fetch_full, lproc, maxr,
                        is_paired, allow_bump=False,
                    )
                    text = out_mod.format_batch(
                        res, self.sp.c, emit_all=self.emit_all,
                        emit_kraken=self.emit_kraken,
                        emit_fastq=self.emit_fastq,
                    )
                    fh.write(text)
                    pieces.append([int(r0), len(text.encode("utf-8"))])
                    n_rows_written += r1 - r0
                idx.append(pieces)
        with open(part + ".idx", "w") as fh:
            _json.dump(
                dict(pid=pid, nproc=jax.process_count(), batches=idx), fh
            )
        return n_rows_written

    def _slice_batch(self, batch, r0: int, r1: int, paired: bool):
        """Row-range [r0, r1) of a ReadBatch (pair rows when paired)."""
        from ..io import fastx

        if paired:
            a, b = 2 * r0, 2 * r1
        else:
            a, b = r0, r1
        return fastx.ReadBatch(
            names=batch.names[a:b], seqs=batch.seqs[a:b],
            codes=batch.codes[a:b], lengths=batch.lengths[a:b],
            quals=batch.quals[a:b] if batch.quals else None,
        )


def bake_rank_images(dirpath: str, tree, db_ranks: int = 0) -> str:
    """Bake per-rank classify-ready memory images for a sharded DB dir:
    for each 'db' rank of a db_ranks-wide mesh (default: one rank per
    shard file), pre-compute the encoded slot words
    from_sharded_dir would build and save them mmap-loadable under
    ``dirpath/rankimg-db{N}-{tree_digest}/``.  Ranks then load by mmap +
    upload with no sort/placement/encode work — the per-rank analog of the
    single-device probe image (util.h:281-372).  Geometry (group size,
    common bucket count, dictionary mode) mirrors from_sharded_dir
    exactly; a loader with different geometry ignores stale images."""
    import json as _json

    from ..db import formats as _formats
    from ..db.formats import read_database_arrays
    from ..db.table import MAX_LOAD, SLOTS, KmerTable, _next_pow2

    with open(os.path.join(dirpath, "manifest.json")) as fh:
        mf = _json.load(fh)
    mfndb = mf["ndb"]
    ndb = db_ranks or mfndb
    if mfndb % ndb or mfndb < ndb:
        raise ValueError(f"db_ranks {ndb} must divide shard count {mfndb}")
    group = mfndb // ndb
    if group > 1:
        sums = [
            sum(mf["shard_n"][r * group:(r + 1) * group])
            for r in range(ndb)
        ]
        nmax = max(max(sums), 1)
        nb = max(_next_pow2(int(np.ceil(nmax / (SLOTS * MAX_LOAD)))), 4)
    elif "nb" in mf:
        nb = int(mf["nb"])
    else:
        nmax = max(max(mf["shard_n"]), 1)
        nb = max(_next_pow2(int(np.ceil(nmax / (SLOTS * MAX_LOAD)))), 4)
    lgnb = int(np.log2(nb))
    vbits = max(lgnb - 2, 0)
    uniq_packed = None
    uf = mf.get("uniq_vals")
    if uf and os.path.exists(os.path.join(dirpath, uf)):
        uv = np.load(os.path.join(dirpath, uf))
        if uv.size and int(uv.max()) <= 0xFFFFFFFF and uv.size <= (
            1 << vbits
        ):
            u32v = uv.astype(np.uint32)
            uniq_packed = (
                u32v.astype(np.uint64) << np.uint64(32)
            ) | tree.compact(u32v, missing_ok=True).astype(
                np.uint32
            ).astype(np.uint64)
    img_dir = os.path.join(
        dirpath, f"rankimg-db{ndb}-{_formats.tree_digest(tree)}"
    )
    os.makedirs(img_dir, exist_ok=True)
    for s in range(ndb):
        ks, vs = [], []
        for f in range(s * group, (s + 1) * group):
            _, kf, vf = read_database_arrays(
                os.path.join(dirpath, mf["shards"][f])
            )
            ks.append(kf)
            vs.append(vf)
        if group == 1:
            keys, vals = ks[0], vs[0]
        else:
            keys = np.concatenate(ks)
            vals = np.concatenate(vs)
            order = np.argsort(keys, kind="stable")
            keys, vals = keys[order], vals[order]
        tbl = KmerTable(keys, vals, min_nb=nb)
        if tbl.nb != nb:
            raise RuntimeError(
                f"rank {s} required bucket growth ({tbl.nb} != {nb})"
            )
        packed = (
            vals.astype(np.uint64) << np.uint64(32)
        ) | tree.compact(vals, missing_ok=True).astype(
            np.uint32
        ).astype(np.uint64)
        if uniq_packed is not None:
            slots, _, inline = tbl._encode_slots(packed, uniq=uniq_packed)
            assert inline
            np.save(os.path.join(img_dir, f"slots-{s:05d}.npy"), slots)
        else:
            slots, flat, inline = tbl._encode_slots(
                packed, allow_inline=False
            )
            assert not inline
            np.save(os.path.join(img_dir, f"slots-{s:05d}.npy"), slots)
            np.save(os.path.join(img_dir, f"vals-{s:05d}.npy"),
                    np.asarray(flat))
    with open(os.path.join(img_dir, "meta.json"), "w") as fh:
        _json.dump(
            dict(format="btpu-rank-images", version=1, ndb=ndb, nb=nb,
                 inline=uniq_packed is not None,
                 tree_digest=_formats.tree_digest(tree)),
            fh,
        )
    return img_dir


def merge_distributed_output(out_dir: str, out_fh) -> int:
    """Reassemble per-rank part files (process_dataset_distributed) into
    the exact byte stream the single-process pipeline would have written:
    for every batch, the per-shard text pieces from all ranks concatenate
    in global row order.  Returns the number of bytes written."""
    import glob
    import json as _json

    parts = sorted(glob.glob(os.path.join(out_dir, "part-*.tsv")))
    idxs = []
    fhs = []
    pids = []
    nprocs = set()
    for p in parts:
        with open(p + ".idx") as fh:
            meta = _json.load(fh)
        idxs.append(meta["batches"])
        pids.append(meta.get("pid"))
        nprocs.add(meta.get("nproc"))
        fhs.append(open(p, "rb"))
    # reject stale part files from an earlier run with a different rank
    # count (the writer only rewrites its own rank's file)
    if parts:
        ok = len(nprocs) == 1
        want_n = nprocs.pop() if ok else None
        known = sorted(p for p in pids if p is not None)
        if not ok or (want_n is not None
                      and (len(known) != len(pids)
                           or known != list(range(want_n)))):
            for fh in fhs:
                fh.close()
            raise ValueError(
                f"{out_dir}: part files for ranks {pids} do not form one "
                f"complete run (expected ranks 0..{want_n}) — stale files "
                f"from a previous run? remove the directory and re-run"
            )
    try:
        n_batches = max((len(i) for i in idxs), default=0)
        total = 0
        for b in range(n_batches):
            pieces = []  # (row_start, rank, nbytes)
            for rank, ix in enumerate(idxs):
                if b < len(ix):
                    for r0, nb in ix[b]:
                        pieces.append((r0, rank, nb))
            # files are written in this same per-rank order, so reading
            # sequentially per rank while emitting in row order is exact
            for r0, rank, nb in sorted(pieces):
                out_fh.write(fhs[rank].read(nb).decode("utf-8"))
                total += nb
        return total
    finally:
        for fh in fhs:
            fh.close()


def sharded_encode_contig(codes, k: int, mesh, canonical: bool = True):
    """Sequence-parallel contig encoding: the contig's code array is sharded
    along 'sp'; each rank encodes its block plus a (k-1)-code halo pulled
    from the right neighbor with ppermute.  Returns per-position canonical
    kmers + validity, sharded like the input.

    This is the build-side analog of blockwise attention: O(1) neighbor
    exchange instead of a serial rolling state (SURVEY §5 long-context)."""
    import jax
    import jax.numpy as jnp
    shard_map = jax.shard_map
    from jax.sharding import PartitionSpec as P

    from ..core import bitops, encode

    nsp = mesh.shape["sp"]
    halo = k - 1

    def local(codes_blk):
        # codes_blk: (1, L_local)
        r = jax.lax.axis_index("sp")
        left_halo = codes_blk[:, :halo]
        # everyone sends its first halo codes to the LEFT neighbor
        perm = [(i, (i - 1) % nsp) for i in range(nsp)]
        recv = jax.lax.ppermute(left_halo, "sp", perm)
        # last rank's received halo wraps around: mark invalid
        recv = jnp.where(r == nsp - 1, jnp.full_like(recv, -1), recv)
        ext = jnp.concatenate([codes_blk, recv], axis=-1)
        kmers, invalid = encode.pack_kmers(ext, k)
        kmers = jnp.where(invalid, jnp.uint64(0), bitops.canonical(kmers, k) if canonical else kmers)
        return kmers, ~invalid

    fn = shard_map(
        local, mesh=mesh, in_specs=(P(None, "sp"),),
        out_specs=(P(None, "sp"), P(None, "sp")),
    )
    return jax.jit(fn)(codes)
