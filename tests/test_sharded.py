"""Multi-device tests on the virtual 8-device CPU mesh: sharded classify
must agree exactly with the single-device classifier; sequence-parallel
encode must agree with the batched encoder."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bonsai_tpu.core.spacer import Spacer
from bonsai_tpu.core.alphabet import DNA4
from bonsai_tpu.core import encode as enc_mod, bitops
from bonsai_tpu.db.table import KmerTable
from bonsai_tpu.db.formats import Database
from bonsai_tpu.classify.pipeline import Classifier
from bonsai_tpu.parallel.mesh import make_mesh
from bonsai_tpu.parallel.sharded import ShardedClassifier, sharded_encode_contig
from bonsai_tpu.taxonomy.tree import TaxTree

from conftest import random_dna

K = 17
TAXONOMY = {1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3}


def make_db(rng, n_keys=5000):
    keys = np.unique(rng.integers(0, 1 << (2 * K), size=n_keys, dtype=np.uint64))
    taxa = rng.choice([1, 2, 3, 11, 12, 13], size=len(keys)).astype(np.uint32)
    return Database(table=KmerTable(keys, taxa), k=K, w=K, gaps=[0] * (K - 1))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    # DB keyed on canonical kmers actually drawn from reads so hits occur
    reads = [random_dna(rng, int(rng.integers(80, 200)), 0.02) for _ in range(96)]
    lut = DNA4.lut
    kms = []
    for r in reads:
        codes = lut[np.frombuffer(r, dtype=np.uint8)][None]
        km, inv = enc_mod.pack_kmers(codes, K)
        kms.append(bitops.canonical(km[~inv], K))
    allk = np.unique(np.concatenate(kms))
    pick = allk[rng.random(len(allk)) < 0.6]
    taxa = rng.choice([1, 2, 3, 11, 12, 13], size=len(pick)).astype(np.uint32)
    db = Database(table=KmerTable(pick, taxa), k=K, w=K, gaps=[0] * (K - 1))
    tree = TaxTree(TAXONOMY)
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), -1, dtype=np.int8)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = lut[np.frombuffer(r, dtype=np.uint8)]
    return db, tree, codes, lengths


@pytest.mark.parametrize(
    "dp,dbs,route",
    [
        (8, 1, "psum"),
        (4, 2, "psum"),
        (2, 4, "psum"),
        (4, 2, "a2a"),
        (2, 4, "a2a"),
        (1, 8, "a2a"),
    ],
)
def test_sharded_matches_single(setup, dp, dbs, route):
    db, tree, codes, lengths = setup
    single = Classifier(db, tree)
    import bonsai_tpu.io.fastx as fastx

    batch = fastx.ReadBatch(
        names=[b""] * len(lengths), seqs=[], codes=codes, lengths=lengths,
        quals=None,
    )
    ref = single.classify_batch(batch, full=True)

    mesh = make_mesh({"dp": dp, "db": dbs})
    sc = ShardedClassifier(db, tree, mesh, route=route)
    taxon, taxa, hit, n_missing, n_kmers, n_kmers1 = sc.step(codes, lengths)
    np.testing.assert_array_equal(np.asarray(taxon), ref.taxon)
    np.testing.assert_array_equal(np.asarray(hit), ref.hit_mask)
    np.testing.assert_array_equal(np.asarray(n_missing), ref.n_missing)
    np.testing.assert_array_equal(
        np.asarray(taxa)[np.asarray(hit)], ref.taxa[ref.hit_mask]
    )


def test_a2a_gather_volume_flat_in_ndb(setup):
    """The a2a route's defining property: per-chip row-gather volume does
    not grow with ndb (the psum route's grows ndb-fold at fixed chip
    count) — BASELINE's 'N chips deliver N chips of probe throughput'."""
    db, tree, codes, lengths = setup
    vols = {}
    for dp, dbs in [(4, 2), (2, 4), (1, 8)]:
        mesh = make_mesh({"dp": dp, "db": dbs})
        sc = ShardedClassifier(db, tree, mesh, route="a2a")
        vols[dbs] = sc.gather_rows_per_step(len(lengths), codes.shape[1])
    base = vols[2]
    for dbs, v in vols.items():
        assert v <= base * 1.02, (dbs, vols)  # flat up to rounding
    # and strictly below the psum design's volume at the same chip count
    mesh = make_mesh({"dp": 2, "db": 4})
    psum = ShardedClassifier(db, tree, mesh, route="psum")
    assert vols[4] < psum.gather_rows_per_step(len(lengths), codes.shape[1]) / 2


def test_a2a_skew_overflow_rounds(setup):
    """Low-complexity reads send ALL their kmers to one owner rank,
    overflowing any per-round capacity; the while_loop must re-route the
    overflow in extra rounds with exact results."""
    db, tree, _, _ = setup
    # every read is one homopolymer: every kmer of a read has ONE owner
    reads = [bytes([c]) * 120 for c in b"ACGT" for _ in range(8)]
    from bonsai_tpu.core.alphabet import DNA4

    codes = np.full((len(reads), 120), -1, dtype=np.int8)
    for i, r in enumerate(reads):
        codes[i] = DNA4.lut[np.frombuffer(r, dtype=np.uint8)]
    lengths = np.full(len(reads), 120, dtype=np.int32)
    import bonsai_tpu.io.fastx as fastx

    single = Classifier(db, tree)
    batch = fastx.ReadBatch(
        names=[b""] * len(reads), seqs=[], codes=codes, lengths=lengths,
        quals=None,
    )
    ref = single.classify_batch(batch, full=True)
    mesh = make_mesh({"dp": 2, "db": 4})
    # tiny capacity factor forces many overflow rounds even on random data
    sc = ShardedClassifier(db, tree, mesh, route="a2a", capacity_factor=0.05)
    taxon, taxa, hit, n_missing, n_kmers, _ = sc.step(codes, lengths)
    np.testing.assert_array_equal(np.asarray(taxon), ref.taxon)
    np.testing.assert_array_equal(np.asarray(hit), ref.hit_mask)
    np.testing.assert_array_equal(np.asarray(n_missing), ref.n_missing)


@pytest.mark.parametrize("route", ["psum", "a2a"])
def test_sharded_paired_matches_single(setup, route):
    db, tree, codes, lengths = setup
    import bonsai_tpu.io.fastx as fastx

    n = (len(lengths) // 2) * 2
    codes, lengths = codes[:n], lengths[:n]
    batch = fastx.ReadBatch(
        names=[b""] * n, seqs=[b""] * n, codes=codes, lengths=lengths,
        quals=None,
    )
    single = Classifier(db, tree)
    ref = single.classify_batch(batch, paired=True, full=True)
    mesh = make_mesh({"dp": 2, "db": 4})
    sc = ShardedClassifier(db, tree, mesh, route=route)
    res = sc.classify_batch(batch, paired=True)
    np.testing.assert_array_equal(res.taxon, ref.taxon)
    np.testing.assert_array_equal(res.n_missing, ref.n_missing)
    np.testing.assert_array_equal(res.n_kmers, ref.n_kmers)
    np.testing.assert_array_equal(res.n_kmers1, ref.n_kmers1)
    np.testing.assert_array_equal(
        res.taxa[res.hit_mask], ref.taxa[ref.hit_mask]
    )


def test_sequence_parallel_encode():
    rng = np.random.default_rng(4)
    mesh = make_mesh({"sp": 8})
    L = 8 * 512
    seq = random_dna(rng, L, 0.01)
    lut = DNA4.lut
    codes = lut[np.frombuffer(seq, dtype=np.uint8)][None]
    kms, valid = sharded_encode_contig(jnp.asarray(codes), K, mesh)
    kms, valid = np.asarray(kms), np.asarray(valid)
    # reference: single-block encode
    ref_km, ref_inv = enc_mod.pack_kmers(codes, K)
    ref_can = np.where(ref_inv, np.uint64(0), bitops.canonical(ref_km, K))
    P = ref_km.shape[-1]
    np.testing.assert_array_equal(valid[0, :P], ~ref_inv[0])
    np.testing.assert_array_equal(kms[0, :P][~ref_inv[0]], ref_can[0][~ref_inv[0]])
    # tail positions (no full kmer) must be invalid
    assert not valid[0, P:].any()


def test_sharded_classify_batch_and_dataset(tmp_path, ec_db_tree=None):
    """ShardedClassifier's host surface (classify_batch/process_dataset)
    matches the single-device Classifier output byte for byte."""
    import io
    import numpy as np
    from bonsai_tpu.classify.pipeline import Classifier
    from bonsai_tpu.parallel.mesh import default_mesh
    from bonsai_tpu.parallel.sharded import ShardedClassifier
    from bonsai_tpu.db.formats import Database
    from bonsai_tpu.db.table import KmerTable
    from bonsai_tpu.taxonomy.tree import TaxTree
    from bonsai_tpu.core import encode as enc_mod, bitops

    rng = np.random.default_rng(3)
    k = 21
    tree = TaxTree({1: 0, 2: 1, 11: 2, 12: 2})
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    reads = [bases[rng.integers(0, 4, 90)].tobytes() for _ in range(37)]
    fq = tmp_path / "r.fa"
    with open(fq, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">q{i}\n{r.decode()}\n")
    # DB from the reads themselves so there are hits
    from bonsai_tpu.core.alphabet import DNA4

    codes = np.stack([DNA4.lut[np.frombuffer(r, np.uint8)] for r in reads])
    km, inv = enc_mod.pack_kmers(codes.astype(np.int8), k)
    pool = np.unique(bitops.canonical(km[~inv], k))
    keys = pool[rng.random(len(pool)) < 0.6]
    taxa = rng.choice([2, 11, 12], size=len(keys)).astype(np.uint32)
    db = Database(table=KmerTable(np.unique(keys), taxa[: len(np.unique(keys))]),
                  k=k, w=k, gaps=[0] * (k - 1))

    single = Classifier(db, tree, emit_all=True)
    mesh = default_mesh(db_shards=2)
    sharded = ShardedClassifier(db, tree, mesh, emit_all=True)

    out1, out2 = io.StringIO(), io.StringIO()
    single.process_dataset(str(fq), out1)
    sharded.process_dataset(str(fq), out2)
    assert out1.getvalue() == out2.getvalue()
    assert sharded.n_classified == single.n_classified


def test_from_sharded_dir_matches_single(setup, tmp_path):
    """Multi-host-style lazy shard loading: a ShardedClassifier built from a
    `build --shards N` directory (per-rank shard files, flat value
    arrays, geometry agreed via the manifest) matches the single-device
    classifier exactly."""
    from bonsai_tpu.db.formats import save_database_sharded

    db, tree, codes, lengths = setup
    d = str(tmp_path / "sh")
    save_database_sharded(db, d, ndb=4)
    single = Classifier(db, tree)
    import bonsai_tpu.io.fastx as fastx

    batch = fastx.ReadBatch(
        names=[b""] * len(lengths), seqs=[], codes=codes, lengths=lengths,
        quals=None,
    )
    ref = single.classify_batch(batch, full=True)
    mesh = make_mesh({"dp": 2, "db": 4})
    sc = ShardedClassifier.from_sharded_dir(d, tree, mesh)
    taxon, taxa, hit, n_missing, n_kmers, _ = sc.step(codes, lengths)
    np.testing.assert_array_equal(np.asarray(taxon), ref.taxon)
    np.testing.assert_array_equal(np.asarray(hit), ref.hit_mask)
    np.testing.assert_array_equal(np.asarray(n_missing), ref.n_missing)
    np.testing.assert_array_equal(
        np.asarray(taxa)[np.asarray(hit)], ref.taxa[ref.hit_mask]
    )
    # shard-count mismatch falls back to merge-load, still exact
    mesh2 = make_mesh({"dp": 4, "db": 2})
    sc2 = ShardedClassifier.from_sharded_dir(d, tree, mesh2)
    taxon2 = sc2.step(codes, lengths)[0]
    np.testing.assert_array_equal(np.asarray(taxon2), ref.taxon)


def test_from_sharded_dir_paired(setup, tmp_path):
    from bonsai_tpu.db.formats import save_database_sharded

    db, tree, codes, lengths = setup
    n = (len(lengths) // 2) * 2
    codes, lengths = codes[:n], lengths[:n]
    d = str(tmp_path / "shp")
    save_database_sharded(db, d, ndb=2)
    import bonsai_tpu.io.fastx as fastx

    batch = fastx.ReadBatch(
        names=[b""] * n, seqs=[b""] * n, codes=codes, lengths=lengths,
        quals=None,
    )
    ref = Classifier(db, tree).classify_batch(batch, paired=True, full=True)
    mesh = make_mesh({"dp": 4, "db": 2})
    sc = ShardedClassifier.from_sharded_dir(d, tree, mesh)
    res = sc.classify_batch(batch, paired=True)
    np.testing.assert_array_equal(res.taxon, ref.taxon)
    np.testing.assert_array_equal(res.n_missing, ref.n_missing)
    np.testing.assert_array_equal(res.n_kmers1, ref.n_kmers1)


def test_a2a_non_pow2_shards(setup):
    """shard_owner is a fixed-point range partition, so ndb need not be a
    power of two (mesh dp=2 x db=3 uses 6 of the 8 virtual devices)."""
    db, tree, codes, lengths = setup
    single = Classifier(db, tree)
    import bonsai_tpu.io.fastx as fastx

    batch = fastx.ReadBatch(
        names=[b""] * len(lengths), seqs=[], codes=codes, lengths=lengths,
        quals=None,
    )
    ref = single.classify_batch(batch, full=True)
    mesh = make_mesh({"dp": 2, "db": 3})
    sc = ShardedClassifier(db, tree, mesh, route="a2a")
    taxon, taxa, hit, n_missing, _, _ = sc.step(codes, lengths)
    np.testing.assert_array_equal(np.asarray(taxon), ref.taxon)
    np.testing.assert_array_equal(np.asarray(hit), ref.hit_mask)
    np.testing.assert_array_equal(np.asarray(n_missing), ref.n_missing)


@pytest.mark.parametrize("trial", range(4))
def test_a2a_fuzz_vs_single(trial):
    """Property fuzz: random k / read lengths / N rate / mesh split /
    capacity factor / canonicalization / spacing — a2a must match the
    single-device classifier exactly."""
    rng = np.random.default_rng(100 + trial)
    k = int(rng.choice([13, 19, 23, 29]))
    canon = bool(rng.integers(0, 2))
    gaps = [0] * (k - 1)
    if trial == 3:  # spaced seed (no canonicalization by construction)
        gaps[int(rng.integers(0, k - 1))] = 2
        canon = False
    sp_c = k + sum(gaps)
    reads = [
        random_dna(rng, int(rng.integers(sp_c + 1, 150)), 0.03)
        for _ in range(48)
    ]
    lut = DNA4.lut
    from bonsai_tpu.core.encoder import BatchEncoder
    from bonsai_tpu.core.spacer import Spacer

    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), -1, dtype=np.int8)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = lut[np.frombuffer(r, dtype=np.uint8)]
    enc = BatchEncoder(Spacer(k, k, gaps), canon, "lex")
    em = enc.emissions(codes, lengths)
    pool = np.unique(np.asarray(em.values)[np.asarray(em.mask)])
    keys = pool[rng.random(len(pool)) < 0.5]
    tree = TaxTree(TAXONOMY)
    taxa = rng.choice([1, 2, 3, 11, 12, 13], size=len(keys)).astype(np.uint32)
    db = Database(table=KmerTable(np.sort(keys), taxa), k=k, w=k, gaps=gaps)

    single = Classifier(db, tree, canonicalize=canon)
    import bonsai_tpu.io.fastx as fastx

    batch = fastx.ReadBatch(
        names=[b""] * len(lengths), seqs=[], codes=codes, lengths=lengths,
        quals=None,
    )
    ref = single.classify_batch(batch, full=True)
    dp, dbs = [(4, 2), (2, 4), (1, 8), (2, 3)][int(rng.integers(0, 4))]
    cf = float(rng.choice([0.1, 0.5, 1.25]))
    mesh = make_mesh({"dp": dp, "db": dbs})
    sc = ShardedClassifier(db, tree, mesh, canonicalize=canon,
                           route="a2a", capacity_factor=cf)
    taxon, taxa_o, hit, n_missing, n_kmers, _ = sc.step(codes, lengths)
    np.testing.assert_array_equal(np.asarray(taxon), ref.taxon)
    np.testing.assert_array_equal(np.asarray(hit), ref.hit_mask)
    np.testing.assert_array_equal(np.asarray(n_missing), ref.n_missing)
    np.testing.assert_array_equal(np.asarray(n_kmers), ref.n_kmers)
    np.testing.assert_array_equal(
        np.asarray(taxa_o)[np.asarray(hit)], ref.taxa[ref.hit_mask]
    )


def test_from_sharded_dir_dictionary_layout(setup, tmp_path):
    """The sharded-dir saver records the agreed bucket count (nb) and the
    DB's global distinct values; the lazy per-rank loader restores the
    inline (replicated unique-values) layout and the 16-bit dictionary
    compact fetch, byte-identical to the single-chip pipeline."""
    import io
    import json
    import os

    from bonsai_tpu.classify import output as out_mod
    from bonsai_tpu.db.formats import save_database_sharded
    import bonsai_tpu.io.fastx as fastx

    db, tree, codes, lengths = setup
    d = str(tmp_path / "shd")
    save_database_sharded(db, d, ndb=4)
    mf = json.load(open(os.path.join(d, "manifest.json")))
    assert "nb" in mf and mf["nb"] >= 4
    assert os.path.exists(os.path.join(d, mf["uniq_vals"]))
    mesh = make_mesh({"dp": 2, "db": 4})
    sc = ShardedClassifier.from_sharded_dir(d, tree, mesh)
    assert sc._inline and sc._uniq_host is not None
    sc.max_runs = 256  # random-taxa DB => run-rich reads; keep compact live
    batch = fastx.ReadBatch(
        names=[f"r{i}".encode() for i in range(len(lengths))],
        seqs=[b""] * len(lengths), codes=codes, lengths=lengths, quals=None,
    )
    single = Classifier(db, tree)
    single.max_runs = 256
    assert single._uniq_host is not None  # dict16 on the single chip too
    ref = single.classify_batch(batch, full=True)
    res = sc._finish_batch(batch, sc._dispatch_batch(batch))
    assert res.compact  # the dict16 RLE fetch, not the full fallback
    assert out_mod.format_batch(res, K, emit_all=True) == out_mod.format_batch(
        ref, K, emit_all=True
    )
