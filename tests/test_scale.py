"""Scale-tier tests (slow): the table/classify machinery at 3x-10x the
ordinary test DB sizes, plus the shard-placement policy.

The full 110M-kmer corpus exercise (build + classify against the
construction + the device probe-cost sweep) runs in chip_smoke.py phase 4
and tools/scale_bench.py; this tier keeps a CI-checkable slice of the same
properties.
"""

import os

import numpy as np
import pytest

from bonsai_tpu.db.formats import (
    Database,
    recommended_shards,
    save_database_sharded,
    table_slot_bytes,
)
from bonsai_tpu.db.table import KmerTable, shard_owner
from bonsai_tpu.taxonomy.tree import TaxTree


def test_recommended_shards_policy():
    """Policy: smallest shard count with per-rank slots <= the measured
    per-device budget (db/formats.py SHARD_SLOT_BUDGET: probe cost on an
    H100 stayed flat up to the largest table measured, 160M keys)."""
    from bonsai_tpu.db.formats import SHARD_SLOT_BUDGET

    # 10M keys -> 2^22 buckets -> slot bytes exactly 128 MiB
    assert table_slot_bytes(10_000_000) == 128 << 20
    # the largest size measured sets the budget: 2^26 buckets, 2 GiB
    assert table_slot_bytes(160_000_000) == SHARD_SLOT_BUDGET == 2 << 30
    assert recommended_shards(8_000_000) == 1
    assert recommended_shards(10_000_000) == 1
    assert recommended_shards(40_000_000) == 1
    assert recommended_shards(110_000_000) == 1
    assert recommended_shards(160_000_000) == 1
    assert recommended_shards(320_000_000) == 2
    assert recommended_shards(1_000_000_000) == 8
    # the budget is a parameter: the same rule at another budget
    assert recommended_shards(40_000_000, budget_bytes=128 << 20) == 4
    # monotone, never absurd
    last = 0
    for n in (1, 10**6, 10**7, 10**8, 10**9, 10**10):
        s = recommended_shards(n)
        assert s >= last
        last = s
        assert table_slot_bytes(-(-n // s)) <= SHARD_SLOT_BUDGET or s == 65536


def test_save_sharded_arrays_equivalent(tmp_path):
    """The streaming array saver (config-5 path, no global placement)
    must produce a directory loadable exactly like save_database_sharded's
    and with identical content."""
    from bonsai_tpu.db.formats import load_database_sharded, save_sharded_arrays

    rng = np.random.default_rng(3)
    n = 50_000
    keys = np.unique(rng.integers(0, 1 << 62, size=n + 500,
                                  dtype=np.uint64))[:n]
    vals = rng.integers(1, 50, size=n).astype(np.uint32)
    db = Database(table=KmerTable(keys, vals), k=31, w=31, gaps=[0] * 30)
    d1 = str(tmp_path / "via_db")
    d2 = str(tmp_path / "via_arrays")
    save_database_sharded(db, d1, ndb=4)
    save_sharded_arrays(keys, vals, d2, ndb=4, k=31, w=31, gaps=[0] * 30)
    a = load_database_sharded(d1)
    b = load_database_sharded(d2)
    np.testing.assert_array_equal(a.table.keys_sorted, b.table.keys_sorted)
    np.testing.assert_array_equal(a.table.vals_sorted, b.table.vals_sorted)
    import json

    with open(f"{d2}/manifest.json") as fh:
        mf = json.load(fh)
    assert mf["ndb"] == 4 and sum(mf["shard_n"]) == n


def test_from_sharded_dir_grouped_ranks(tmp_path):
    """A sharded dir with MORE shard files than mesh 'db' ranks loads by
    grouping consecutive files per rank (valid because the fixed-point
    hash-prefix partition is hierarchical: owner_at(ndb) ==
    owner_at(ndb*g) // g) and classifies identically to the
    single-device classifier."""
    import bonsai_tpu.io.fastx as fastx
    from bonsai_tpu.classify import output as out_mod
    from bonsai_tpu.classify.pipeline import Classifier
    from bonsai_tpu.core.alphabet import DNA4
    from bonsai_tpu.db.formats import save_sharded_arrays
    from bonsai_tpu.parallel.mesh import make_mesh
    from bonsai_tpu.parallel.sharded import ShardedClassifier

    rng = np.random.default_rng(5)
    Kk = 31
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    contig = bases[rng.integers(0, 4, 300_000)].tobytes()
    from bonsai_tpu.core import bitops, encode as enc_mod

    codes = DNA4.lut[np.frombuffer(contig, np.uint8)][None]
    km, inv = enc_mod.pack_kmers(codes, Kk)
    keys = np.unique(bitops.canonical(km[~inv], Kk))
    vals = np.full(keys.size, 11, dtype=np.uint32)
    vals[rng.random(keys.size) < 0.4] = 12
    tree = TaxTree({1: 0, 2: 1, 11: 2, 12: 2})
    db = Database(table=KmerTable(keys, vals), k=Kk, w=Kk, gaps=[0] * 30)

    d = str(tmp_path / "sh8")
    save_sharded_arrays(keys, vals, d, ndb=8, k=Kk, w=Kk, gaps=[0] * 30)

    reads = []
    for i in range(48):
        s = int(rng.integers(0, len(contig) - 101))
        reads.append(contig[s : s + 101])
    rcodes = np.stack(
        [DNA4.lut[np.frombuffer(r, np.uint8)] for r in reads]
    ).astype(np.int8)
    batch = fastx.ReadBatch(
        names=[f"r{i}".encode() for i in range(48)], seqs=reads,
        codes=rcodes, lengths=np.full(48, 101, np.int32),
        quals=[None] * 48,
    )
    ref = out_mod.format_batch(
        Classifier(db, tree).classify_batch(batch, full=True), Kk,
        emit_all=True,
    )
    # 8 files over 2 db ranks (group=4) and over 4 db ranks (group=2)
    for dbr in (2, 4):
        mesh = make_mesh({"dp": 2, "db": dbr})
        sc = ShardedClassifier.from_sharded_dir(d, tree, mesh)
        res = sc._finish_batch(batch, sc._dispatch_batch(batch))
        assert out_mod.format_batch(res, Kk, emit_all=True) == ref, dbr


def test_rank_images_parity(tmp_path):
    """Per-rank memory images (bake_rank_images): from_sharded_dir must
    take the mmap path (no per-rank sort/place/encode) and classify
    byte-identically to the image-less load, at both the native width
    and a grouped width."""
    import bonsai_tpu.io.fastx as fastx
    from bonsai_tpu.classify import output as out_mod
    from bonsai_tpu.core import bitops, encode as enc_mod
    from bonsai_tpu.core.alphabet import DNA4
    from bonsai_tpu.db.formats import save_sharded_arrays
    from bonsai_tpu.parallel.mesh import make_mesh
    from bonsai_tpu.parallel.sharded import (
        ShardedClassifier,
        bake_rank_images,
    )

    rng = np.random.default_rng(9)
    Kk = 31
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    contig = bases[rng.integers(0, 4, 200_000)].tobytes()
    codes = DNA4.lut[np.frombuffer(contig, np.uint8)][None]
    km, inv = enc_mod.pack_kmers(codes, Kk)
    keys = np.unique(bitops.canonical(km[~inv], Kk))
    vals = np.full(keys.size, 11, dtype=np.uint32)
    vals[rng.random(keys.size) < 0.5] = 12
    tree = TaxTree({1: 0, 2: 1, 11: 2, 12: 2})
    d = str(tmp_path / "sh4")
    save_sharded_arrays(keys, vals, d, ndb=4, k=Kk, w=Kk, gaps=[0] * 30)

    reads = []
    for i in range(32):
        s = int(rng.integers(0, len(contig) - 101))
        reads.append(contig[s : s + 101])
    rcodes = np.stack(
        [DNA4.lut[np.frombuffer(r, np.uint8)] for r in reads]
    ).astype(np.int8)
    batch = fastx.ReadBatch(
        names=[f"r{i}".encode() for i in range(32)], seqs=reads,
        codes=rcodes, lengths=np.full(32, 101, np.int32),
        quals=[None] * 32,
    )

    for dbr in (4, 2):
        mesh = make_mesh({"dp": 2, "db": dbr})
        sc0 = ShardedClassifier.from_sharded_dir(d, tree, mesh)
        assert sc0._rank_images_used is False
        ref = out_mod.format_batch(
            sc0._finish_batch(batch, sc0._dispatch_batch(batch)), Kk,
            emit_all=True,
        )
        bake_rank_images(d, tree, dbr)
        sc1 = ShardedClassifier.from_sharded_dir(d, tree, mesh)
        assert sc1._rank_images_used is True
        got = out_mod.format_batch(
            sc1._finish_batch(batch, sc1._dispatch_batch(batch)), Kk,
            emit_all=True,
        )
        assert got == ref, dbr
    # wrong tree -> stale digest -> images ignored, classify still works
    other = TaxTree({1: 0, 2: 1, 11: 2, 12: 2, 13: 2})
    mesh = make_mesh({"dp": 2, "db": 4})
    sc2 = ShardedClassifier.from_sharded_dir(d, other, mesh)
    assert sc2._rank_images_used is False


@pytest.mark.slow
def test_table_at_32m_keys_probe_exact():
    """Quotient-cuckoo table at 32M keys (3x the ordinary test DBs, 537MB
    slot array geometry class): build converges, probes are exact for
    hits and misses, and the hash-prefix shard split covers the keys."""
    rng = np.random.default_rng(0)
    n = 32_000_000
    keys = np.unique(rng.integers(0, 1 << 62, size=int(n * 1.02),
                                  dtype=np.uint64))[:n]
    vals = rng.integers(1, 1000, size=n).astype(np.uint32)
    t = KmerTable(keys, vals)
    assert t.n == n
    pick = rng.integers(0, n, size=200_000)
    v, f = t.probe_np(keys[pick])
    assert bool(f.all())
    np.testing.assert_array_equal(v, vals[pick])
    misses = rng.integers(0, 1 << 62, size=200_000, dtype=np.uint64)
    _, fm = t.probe_np(misses)
    # random u64s collide with 32M keys at ~32M/2^62 per probe
    assert int(fm.sum()) <= 5
    own = shard_owner(keys, 4)
    counts = np.bincount(own, minlength=4)
    assert counts.sum() == n
    assert counts.max() / counts.min() < 1.01  # near-uniform split


@pytest.mark.slow
def test_gather_cliff_boundary_behavioral():
    """The shard policy, exercised as BEHAVIOR at a budget boundary: 16M
    keys build a single table whose slot array (256 MiB) is past a 128 MiB
    budget (the device budget, SHARD_SLOT_BUDGET, is too large to cross in
    a test), the policy says split in 2, and the 2-way hash-prefix split
    yields per-rank tables back inside the budget that probe EXACTLY the
    same answers (hits and misses) as the oversized single table."""
    from bonsai_tpu.db.table import SLOTS, HashShardedTable

    SHARD_SLOT_BUDGET = 128 << 20

    rng = np.random.default_rng(7)
    n = 16_000_000
    keys = np.unique(rng.integers(0, 1 << 62, size=int(n * 1.02),
                                  dtype=np.uint64))[:n]
    vals = rng.integers(1, 5000, size=n).astype(np.uint32)

    # policy boundary: single-table slots are PAST the budget; the
    # recommended split is 2; the split halves are INSIDE the budget
    assert table_slot_bytes(n) > SHARD_SLOT_BUDGET
    assert recommended_shards(n, budget_bytes=SHARD_SLOT_BUDGET) == 2
    assert table_slot_bytes(-(-n // 2)) <= SHARD_SLOT_BUDGET

    single = KmerTable(keys, vals)
    assert single.nb * SLOTS * 8 > SHARD_SLOT_BUDGET  # past the budget
    sharded = HashShardedTable(single, ndb=2)
    for sub in sharded.shards:
        assert sub.nb * SLOTS * 8 <= SHARD_SLOT_BUDGET

    pick = rng.integers(0, n, size=100_000)
    qs = keys[pick]
    v1, f1 = single.probe_np(qs)
    assert bool(f1.all())
    own = shard_owner(qs, 2)
    for o in (0, 1):
        sel = own == o
        v2, f2 = sharded.shards[o].probe_np(qs[sel])
        assert bool(f2.all())
        np.testing.assert_array_equal(v2, v1[sel])
    misses = rng.integers(0, 1 << 62, size=100_000, dtype=np.uint64)
    _, fm1 = single.probe_np(misses)
    fm2 = np.zeros(misses.size, bool)
    own = shard_owner(misses, 2)
    for o in (0, 1):
        sel = own == o
        _, f = sharded.shards[o].probe_np(misses[sel])
        fm2[sel] = f
    np.testing.assert_array_equal(fm1, fm2)


@pytest.mark.slow
def test_sharded_dir_roundtrip_at_scale(tmp_path):
    """save --shards / per-rank lazy load / classify agreement at a DB
    ~3x the ordinary test scale, through the real virtual-mesh path."""
    import io

    import bonsai_tpu.io.fastx as fastx
    from bonsai_tpu.classify import output as out_mod
    from bonsai_tpu.classify.pipeline import Classifier
    from bonsai_tpu.core import bitops, encode as enc_mod
    from bonsai_tpu.core.alphabet import DNA4
    from bonsai_tpu.parallel.mesh import make_mesh
    from bonsai_tpu.parallel.sharded import ShardedClassifier

    rng = np.random.default_rng(1)
    K = 31
    # one synthetic 8-Mb genome -> ~8M distinct canonical kmers, plus
    # random keys to reach ~24M
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    contig = bases[rng.integers(0, 4, 8_000_000)].tobytes()
    codes = DNA4.lut[np.frombuffer(contig, np.uint8)][None]
    km, inv = enc_mod.pack_kmers(codes, K)
    gk = np.unique(bitops.canonical(km[~inv], K))
    extra = rng.integers(0, 1 << 62, size=16_000_000, dtype=np.uint64)
    keys = np.unique(np.concatenate([gk, bitops.canonical(extra, K)]))
    vals = np.full(keys.size, 11, dtype=np.uint32)
    vals[rng.random(keys.size) < 0.3] = 12
    tree = TaxTree({1: 0, 2: 1, 11: 2, 12: 2})
    db = Database(table=KmerTable(keys, vals), k=K, w=K, gaps=[0] * (K - 1))
    d = str(tmp_path / "scale_shards")
    ndb = recommended_shards(keys.size, budget_bytes=128 << 20)
    assert ndb >= 2
    save_database_sharded(db, d, ndb=min(ndb, 4))

    reads = []
    for i in range(64):
        s = int(rng.integers(0, len(contig) - 101))
        reads.append(contig[s : s + 101])
    rcodes = np.stack(
        [DNA4.lut[np.frombuffer(r, np.uint8)] for r in reads]
    ).astype(np.int8)
    batch = fastx.ReadBatch(
        names=[f"r{i}".encode() for i in range(64)], seqs=reads,
        codes=rcodes, lengths=np.full(64, 101, np.int32),
        quals=[None] * 64,
    )
    single = Classifier(db, tree)
    ref = out_mod.format_batch(
        single.classify_batch(batch, full=True), K, emit_all=True
    )
    mesh = make_mesh({"dp": 2, "db": min(ndb, 4)})
    sc = ShardedClassifier.from_sharded_dir(d, tree, mesh)
    res = sc._finish_batch(batch, sc._dispatch_batch(batch))
    assert out_mod.format_batch(res, K, emit_all=True) == ref
