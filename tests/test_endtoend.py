"""End-to-end: DB build from real genomes + classification vs host oracle.

The reference binary cannot be built in this environment (its hll/zlib/zstd
submodules are empty), so per-read parity is checked against a trusted host
oracle: the scalar-port oracle encoder + a python dict DB + the
reference-exact resolve_tree_host.
"""

import io
import os

import numpy as np
import pytest

from bonsai_tpu.core.spacer import Spacer
from bonsai_tpu.db.build import lca_map, genome_kmer_set, taxdepth_map, minimized_map, TDtax, TDdepth
from bonsai_tpu.db.formats import (
    Database,
    save_database,
    load_database,
    write_bonsai_database,
    import_bonsai_database,
)
from bonsai_tpu.db.table import KmerTable
from bonsai_tpu.classify.pipeline import Classifier
from bonsai_tpu.classify import output as out_mod
from bonsai_tpu.taxonomy.tree import TaxTree
from bonsai_tpu.taxonomy.ncbi import accession_from_header
from bonsai_tpu.io import fastx

from oracle import OracleEncoder

DATA = os.path.join(os.path.dirname(__file__), "data")

GENOMES = [
    os.path.join(DATA, "ec", "GCF_000005845.2_ASM584v2_genomic.fna.gz"),
    os.path.join(DATA, "ec", "GCF_000007445.1_ASM744v1_genomic.fna.gz"),
    os.path.join(DATA, "phix.fa"),
]
#      1
#      |
#      2          (E. coli species)
#     / \
#   11   12       (strains)          13 = phiX under root
TAXONOMY = {1: 0, 2: 1, 11: 2, 12: 2, 13: 1}
GENOME_TAX = {0: 11, 1: 12, 2: 13}
K = 21


@pytest.fixture(scope="module")
def name_map():
    nm = {}
    for gi, path in enumerate(GENOMES):
        hdr = fastx.first_header(path)
        nm[accession_from_header(hdr)] = GENOME_TAX[gi]
    return nm


@pytest.fixture(scope="module")
def tree():
    return TaxTree(TAXONOMY)


@pytest.fixture(scope="module")
def db(tree, name_map):
    sp = Spacer(K, K)
    table = lca_map(GENOMES, tree, name_map, sp, canonicalize=True)
    return Database(table=table, k=K, w=K, gaps=[0] * (K - 1))


def simulate_reads(rng, n, readlen=120, n_prob=0.01):
    """Reads drawn from the genomes + some random reads."""
    contigs = []
    for path in GENOMES:
        for _, seq, _ in fastx.read_fastx(path):
            if len(seq) >= readlen:
                contigs.append(seq)
    reads = []
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    for i in range(n):
        if rng.random() < 0.15:
            reads.append(bases[rng.integers(0, 4, readlen)].tobytes())
            continue
        c = contigs[rng.integers(len(contigs))]
        start = int(rng.integers(0, len(c) - readlen + 1))
        r = bytearray(c[start : start + readlen])
        # mutations + Ns
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(readlen))] = int(bases[rng.integers(4)])
        if rng.random() < n_prob * readlen:
            r[int(rng.integers(readlen))] = ord("N")
        reads.append(bytes(r))
    return reads


def oracle_classify(db, tree, reads, k):
    """Host oracle: oracle encoder + dict probe + resolve_tree_host."""
    dbdict = dict(zip(db.table.keys_sorted.tolist(), db.table.vals_sorted.tolist()))
    enc = OracleEncoder(Spacer(k, k), canonicalize=True)
    out = []
    details = []
    for r in reads:
        hits = {}
        taxa = []
        missing = 0
        for km in enc.for_each(r):
            v = dbdict.get(km)
            if v is None:
                missing += 1
            else:
                taxa.append(v)
                hits[v] = hits.get(v, 0) + 1
        taxon = tree.resolve_tree_host(hits)
        out.append(taxon)
        details.append((taxa, missing))
    return out, details


def test_db_content_is_lca(db, tree, name_map):
    """Every key's value equals the LCA of the taxa of genomes containing
    it (direct check on a subsample)."""
    rng = np.random.default_rng(0)
    sp = Spacer(K, K)
    gsets = [set(genome_kmer_set(p, sp).tolist()) for p in GENOMES]
    keys = db.table.keys_sorted
    sample = rng.choice(len(keys), size=min(3000, len(keys)), replace=False)
    for i in sample:
        km = int(keys[i])
        taxa = [GENOME_TAX[g] for g, s in enumerate(gsets) if km in s]
        assert taxa, "key not in any genome set"
        want = taxa[0]
        for t in taxa[1:]:
            want = tree.lca(want, t)
        assert int(db.table.vals_sorted[i]) == want


def test_probe_roundtrip(db):
    rng = np.random.default_rng(1)
    keys = db.table.keys_sorted
    idx = rng.choice(len(keys), size=5000, replace=False)
    vals, found = db.table.probe_np(keys[idx])
    assert found.all()
    np.testing.assert_array_equal(vals, db.table.vals_sorted[idx])
    # misses
    fake = rng.integers(0, 1 << 42, size=1000, dtype=np.uint64) | np.uint64(1 << 60)
    _, found = db.table.probe_np(fake)
    assert not found.any()


def test_classify_matches_oracle(db, tree):
    rng = np.random.default_rng(7)
    reads = simulate_reads(rng, 300)
    want, details = oracle_classify(db, tree, reads, K)
    clf = Classifier(db, tree)
    res_taxon = clf.classify_reads(reads)
    got = [int(t) for t in res_taxon]
    assert got == want
    # classification counters
    assert clf.n_classified == sum(1 for t in want if t)
    assert clf.n_unclassified == sum(1 for t in want if not t)


def test_classify_detail_and_output(db, tree):
    rng = np.random.default_rng(9)
    reads = simulate_reads(rng, 64)
    want, details = oracle_classify(db, tree, reads, K)
    clf = Classifier(db, tree, emit_all=True)
    maxlen = max(len(r) for r in reads)
    codes = np.full((len(reads), maxlen), -1, dtype=np.int8)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = clf.lut[np.frombuffer(r, dtype=np.uint8)]
    batch = fastx.ReadBatch(
        names=[f"r{i}".encode() for i in range(len(reads))],
        seqs=reads, codes=codes, lengths=lengths, quals=[None] * len(reads),
    )
    res = clf.classify_batch(batch)
    for i, (taxa, missing) in enumerate(details):
        got_taxa = res.hit_taxa(i).tolist()
        assert got_taxa == taxa, f"read {i} hit taxa"
        assert int(res.n_missing[i]) == missing
    text = out_mod.format_batch(res, K, emit_all=True)
    lines = text.strip("\n").split("\n")
    assert len(lines) == len(reads)
    for i, line in enumerate(lines):
        cols = line.split("\t")
        assert cols[0] == ("C" if want[i] else "U")
        assert cols[1] == f"r{i}"
        assert int(cols[2]) == want[i]
        assert int(cols[3]) == len(reads[i])
        if want[i]:
            # run lengths sum to number of hits
            runs = [c for c in cols[4:] if ":" in c and not c.startswith(("M:", "A:"))]
            total = sum(int(r.split(":")[1]) for r in runs)
            assert total == len(details[i][0])


@pytest.mark.slow
def test_native_format_roundtrip(db, tmp_path):
    p = str(tmp_path / "db.btpu")
    save_database(db, p)
    db2 = load_database(p)
    np.testing.assert_array_equal(db2.table.keys_sorted, db.table.keys_sorted)
    np.testing.assert_array_equal(db2.table.vals_sorted, db.table.vals_sorted)
    assert db2.k == db.k and db2.w == db.w and db2.gaps == db.gaps
    # gz flavor
    pgz = str(tmp_path / "db.btpu.gz")
    save_database(db, pgz)
    db3 = load_database(pgz)
    np.testing.assert_array_equal(db3.table.keys_sorted, db.table.keys_sorted)


def test_bonsai_format_roundtrip(db, tmp_path):
    p = str(tmp_path / "db.bonsai")
    write_bonsai_database(db, p)
    db2 = import_bonsai_database(p)
    np.testing.assert_array_equal(db2.table.keys_sorted, db.table.keys_sorted)
    np.testing.assert_array_equal(
        db2.table.vals_sorted.astype(np.uint32), db.table.vals_sorted
    )
    assert db2.k == db.k and db2.w == db.w


def test_bonsai_khash_probe_semantics(tmp_path):
    """The exported khash image must be probe-consistent: simulate klib
    kh_get over the raw image for every key and for misses."""
    from bonsai_tpu.db.formats import _khash_layout, _kh_hash

    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 62, size=20000, dtype=np.uint64))
    vals = rng.integers(0, 1 << 31, size=len(keys), dtype=np.uint32)
    nb, sk, sv, occ = _khash_layout(keys, vals)
    mask = nb - 1

    def kh_get(key):
        k = int(_kh_hash(np.array([key], dtype=np.uint64))[0])
        i = k & mask
        step = 0
        last = i
        while occ[i] and sk[i] != key:
            step += 1
            i = (i + step) & mask
            if i == last:
                return None
        return i if occ[i] and sk[i] == key else None

    idx = rng.choice(len(keys), size=400, replace=False)
    for key, val in zip(keys[idx].tolist(), vals[idx].tolist()):
        slot = kh_get(key)
        assert slot is not None, f"key {key} unreachable"
        assert sv[slot] == val
    for key in rng.integers(1 << 62, 1 << 63, size=200, dtype=np.uint64).tolist():
        assert kh_get(key) is None


@pytest.mark.slow
def test_phase1_taxdepth_and_minimized(tree, name_map, tmp_path):
    sp = Spacer(K, K)
    p1 = taxdepth_map(GENOMES, tree, name_map, sp)
    # kmers present in both E. coli strains but not phiX -> lca 2, depth 2
    t = TDtax(p1.vals_sorted)
    d = TDdepth(p1.vals_sorted)
    for tax, depth in ((11, 3), (12, 3), (13, 2), (2, 2), (1, 1)):
        m = t == tax
        if m.any():
            assert (d[m] == depth).all()
    p2 = minimized_map(GENOMES, p1, tree, name_map, sp)
    np.testing.assert_array_equal(p2.keys_sorted, p1.keys_sorted)
    np.testing.assert_array_equal(p2.vals_sorted, TDtax(p1.vals_sorted))


def _make_batch(reads, clf):
    maxlen = max(len(r) for r in reads)
    codes = np.full((len(reads), maxlen), -1, dtype=np.int8)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = clf.lut[np.frombuffer(r, dtype=np.uint8)]
    return fastx.ReadBatch(
        names=[f"r{i}".encode() for i in range(len(reads))],
        seqs=reads, codes=codes, lengths=lengths, quals=[None] * len(reads),
    )


def test_compact_output_matches_full(db, tree):
    """The device-RLE compact fetch must format byte-identically to the
    full positional-matrix fetch, through both the native and python
    formatters."""
    rng = np.random.default_rng(11)
    reads = simulate_reads(rng, 96)
    clf = Classifier(db, tree)
    batch = _make_batch(reads, clf)
    res_c = clf.classify_batch(batch)
    res_f = clf.classify_batch(batch, full=True)
    assert res_f.taxa is not None and res_f.hit_mask is not None
    np.testing.assert_array_equal(res_c.taxon, res_f.taxon)
    np.testing.assert_array_equal(res_c.n_missing, res_f.n_missing)
    np.testing.assert_array_equal(res_c.n_kmers, res_f.n_kmers)
    for i in range(len(reads)):
        np.testing.assert_array_equal(res_c.hit_taxa(i), res_f.hit_taxa(i))
    text_f = out_mod.format_batch(res_f, K, emit_all=True)
    text_c = out_mod.format_batch(res_c, K, emit_all=True)
    assert text_c == text_f
    if res_c.compact:
        from bonsai_tpu.classify.output import _format_batch_python

        assert _format_batch_python(res_c, K, emit_all=True) == text_f


def test_compact_overflow_falls_back(db, tree):
    """Reads with more hit runs than the device capacity transparently use
    the full positional fetch with identical output."""
    rng = np.random.default_rng(13)
    reads = simulate_reads(rng, 48)
    ref = Classifier(db, tree)
    batch = _make_batch(reads, ref)
    text_ref = out_mod.format_batch(
        ref.classify_batch(batch, full=True), K, emit_all=True
    )
    tiny = Classifier(db, tree)
    tiny.max_runs = 1  # force overflow for any read with >1 run
    res = tiny.classify_batch(batch)
    assert out_mod.format_batch(res, K, emit_all=True) == text_ref


def test_compact_output_paired(db, tree):
    """Compact RLE over merged mate pairs (runs can span the mate
    boundary) matches the full fetch."""
    rng = np.random.default_rng(17)
    reads = simulate_reads(rng, 32)  # 16 pairs, interleaved
    clf = Classifier(db, tree)
    batch = _make_batch(reads, clf)
    res_c = clf.classify_batch(batch, paired=True)
    res_f = clf.classify_batch(batch, paired=True, full=True)
    np.testing.assert_array_equal(res_c.taxon, res_f.taxon)
    for i in range(len(reads) // 2):
        np.testing.assert_array_equal(res_c.hit_taxa(i), res_f.hit_taxa(i))
    assert out_mod.format_batch(res_c, K, emit_all=True) == out_mod.format_batch(
        res_f, K, emit_all=True
    )


def test_adaptive_run_capacity_bump(tmp_path):
    """Run-rich reads overflow the compact RLE capacity; after a few
    full-matrix fallbacks max_runs doubles (one recompile) and output
    stays byte-identical throughout."""
    import io
    import numpy as np
    from bonsai_tpu.classify.pipeline import Classifier
    from bonsai_tpu.db.table import KmerTable
    from bonsai_tpu.db.formats import Database
    from bonsai_tpu.taxonomy.tree import TaxTree
    from bonsai_tpu.core import encode as enc_mod, bitops
    from bonsai_tpu.core.alphabet import DNA4

    rng = np.random.default_rng(11)
    k = 15
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    reads = [bases[rng.integers(0, 4, 120)].tobytes() for _ in range(64)]
    codes = np.stack(
        [DNA4.lut[np.frombuffer(r, np.uint8)] for r in reads]
    ).astype(np.int8)
    km, inv = enc_mod.pack_kmers(codes, k)
    keys = np.unique(bitops.canonical(km[~inv], k))
    # alternate taxids along the sorted key order: consecutive read
    # positions hit different taxa -> many runs per read (> 8 and > 16)
    taxa = (11 + (np.arange(len(keys)) % 4)).astype(np.uint32)
    tree = TaxTree({1: 0, 2: 1, 11: 2, 12: 2, 13: 2, 14: 2})
    db = Database(table=KmerTable(keys, taxa), k=k, w=k, gaps=[0] * (k - 1))

    fa = tmp_path / "r.fa"
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">q{i}\n{r.decode()}\n")

    # reference: full positional fetch path (no RLE involved)
    ref_clf = Classifier(db, tree, emit_all=True)
    ref = io.StringIO()
    for batch in __import__("bonsai_tpu").io.fastx.batch_reads(
        str(fa), ref_clf.lut, batch_size=8
    ):
        res = ref_clf.classify_batch(batch, full=True)
        from bonsai_tpu.classify import output as out_mod

        ref.write(out_mod.format_batch(res, ref_clf.sp.c, emit_all=True))

    clf = Classifier(db, tree, emit_all=True)
    clf.max_runs = 4  # force overflow on every batch initially
    out = io.StringIO()
    clf.process_dataset(str(fa), out, batch_size=8)
    assert out.getvalue() == ref.getvalue()
    assert clf.max_runs > 4  # the adaptive bump fired


def test_long_read_classify(tmp_path):
    """Multi-kb reads (nanopore-style): the blockwise resolve must match
    the dense formulation and the pipeline must classify a 6 kb read
    end-to-end (the reference's per-read loop is length-agnostic,
    classifier.h:212)."""
    import numpy as np
    import jax.numpy as jnp
    from bonsai_tpu.classify.resolve import resolve_batch
    from bonsai_tpu.classify.pipeline import Classifier
    from bonsai_tpu.db.table import KmerTable
    from bonsai_tpu.db.formats import Database
    from bonsai_tpu.taxonomy.tree import TaxTree
    from bonsai_tpu.core import encode as enc_mod, bitops
    from bonsai_tpu.core.alphabet import DNA4

    rng = np.random.default_rng(21)
    tree = TaxTree({1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3})
    tax = tree.device_arrays()
    n_tax = int(np.asarray(tax["tin"]).shape[0])
    # blockwise == dense on random hit patterns
    B, P = 4, 2500
    idx = rng.integers(0, n_tax, size=(B, P)).astype(np.int32)
    mask = rng.random((B, P)) < 0.4
    dense = resolve_batch(jnp.asarray(idx), jnp.asarray(mask), tax,
                          block=1 << 20)
    blocked = resolve_batch(jnp.asarray(idx), jnp.asarray(mask), tax,
                            block=512)
    np.testing.assert_array_equal(np.asarray(dense), np.asarray(blocked))

    # end-to-end: one 6 kb read through the full pipeline
    k = 21
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    long_read = bases[rng.integers(0, 4, 6000)].tobytes()
    codes = DNA4.lut[np.frombuffer(long_read, np.uint8)][None].astype(np.int8)
    km, inv = enc_mod.pack_kmers(codes, k)
    pool = np.unique(bitops.canonical(km[~inv], k))
    keys = pool[rng.random(len(pool)) < 0.3]
    taxa = rng.choice([2, 11, 12, 13], size=len(keys)).astype(np.uint32)
    db = Database(table=KmerTable(keys, taxa), k=k, w=k, gaps=[0] * (k - 1))
    clf = Classifier(db, tree)
    taxon = clf.classify_reads([long_read])
    assert taxon.shape == (1,) and int(taxon[0]) != 0


def test_pipeline_error_propagation(tmp_path):
    """Exceptions in the writer thread must surface in the caller and the
    producer/writer threads must shut down cleanly (no deadlock)."""
    import numpy as np
    from bonsai_tpu.classify.pipeline import Classifier
    from bonsai_tpu.db.table import KmerTable
    from bonsai_tpu.db.formats import Database
    from bonsai_tpu.taxonomy.tree import TaxTree

    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 30, 500, dtype=np.uint64))
    db = Database(
        table=KmerTable(keys, np.full(len(keys), 2, np.uint32)),
        k=15, w=15, gaps=[0] * 14,
    )
    clf = Classifier(db, TaxTree({1: 0, 2: 1}))
    fa = tmp_path / "r.fa"
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    with open(fa, "w") as fh:
        for i in range(300):
            fh.write(f">q{i}\n{bases[rng.integers(0,4,60)].tobytes().decode()}\n")

    class Boom(Exception):
        pass

    class FailingSink:
        def write(self, _):
            raise Boom("sink failed")

    import io

    import pytest

    with pytest.raises(Boom):
        clf.process_dataset(str(fa), FailingSink(), batch_size=64)
    # the classifier is reusable after the failure (pipeline threads
    # retired cleanly, no stuck queues)
    sink = io.StringIO()
    clf.process_dataset(str(fa), sink, batch_size=64)
    assert sink.getvalue().count("\n") == 0 or sink.getvalue()


def test_dict16_dictionary_fetch_active(db, tree):
    """The ec classify DB has a handful of distinct LCA taxids, so the
    default pipeline must run in dictionary mode (16-bit value indices on
    the wire); the compact/full parity tests above then cover the dict16
    decode byte-for-byte."""
    clf = Classifier(db, tree)
    uniq = clf._uniq_host
    assert uniq is not None
    np.testing.assert_array_equal(
        uniq, np.unique(db.table.vals_sorted).astype(np.uint32)
    )
    # dictionary indices round-trip through the step outputs
    rng = np.random.default_rng(23)
    reads = simulate_reads(rng, 32)
    batch = _make_batch(reads, clf)
    res = clf.classify_batch(batch)
    if res.compact:
        assert set(np.unique(res.run_vals)).issubset(set(uniq.tolist()))


def test_no_n_upload_variant_parity(db, tree):
    """Batches without in-read Ns skip the N-bitmask upload (a third of
    the host->device bytes); output must match the full fetch and the
    masked variant bit-for-bit."""
    rng = np.random.default_rng(29)
    clean = simulate_reads(rng, 24, n_prob=0.0)
    noisy = simulate_reads(rng, 24, n_prob=0.05)
    clf = Classifier(db, tree)
    b_clean = _make_batch(clean, clf)
    b_noisy = _make_batch(noisy, clf)
    assert clf._prepare_batch(b_clean)[1] is None  # no-N fast path taken
    assert clf._prepare_batch(b_noisy)[1] is not None
    for b in (b_clean, b_noisy):
        rc = clf.classify_batch(b)
        rf = clf.classify_batch(b, full=True)
        np.testing.assert_array_equal(rc.taxon, rf.taxon)
        np.testing.assert_array_equal(rc.n_missing, rf.n_missing)
        np.testing.assert_array_equal(rc.n_kmers, rf.n_kmers)
        assert out_mod.format_batch(rc, K, emit_all=True) == \
            out_mod.format_batch(rf, K, emit_all=True)


def test_resolve_dedup_matches_dense():
    """Long-read resolve: the distinct-taxa dedup path (sort + counts +
    (B, D, D) weighted ancestor matrix) must equal the dense/blockwise
    per-position formulation bit-for-bit, including ties and all-miss
    rows (resolve over distinct taxa mirrors util.h:831-869)."""
    import jax.numpy as jnp

    from bonsai_tpu.classify.resolve import resolve_batch

    tx = {1: 0}
    for i in range(2, 12):
        tx[i] = 1
    for i in range(12, 32):
        tx[i] = 2 + (i % 10)
    t = TaxTree(tx)
    tax = t.device_arrays()
    n = len(np.asarray(tax["tin"]))
    rng = np.random.default_rng(3)
    for _ in range(4):
        B = int(rng.integers(1, 6))
        P = int(rng.integers(257, 2500))
        dmax = int(rng.integers(2, n))
        v = rng.integers(1, dmax + 1, size=(B, P)).astype(np.int32)
        m = rng.random((B, P)) < rng.random()
        v = np.where(m, v, 0)
        dense = np.asarray(
            resolve_batch(jnp.asarray(v), jnp.asarray(m), tax)
        )
        dedup = np.asarray(
            resolve_batch(jnp.asarray(v), jnp.asarray(m), tax, n_distinct=n)
        )
        np.testing.assert_array_equal(dense, dedup)


@pytest.mark.slow
def test_sustained_stream_bounded_memory(db, tree, tmp_path):
    """A long single-stream run (60k reads here; bench.py runs 1M on the
    chip) must hold steady-state memory: the pipeline queues are bounded
    (depth 4), so RSS growth between the 1st and 5th pass over the same
    reads should be ~0 (no per-batch accumulation)."""
    import io
    import resource

    rng = np.random.default_rng(41)
    reads = simulate_reads(rng, 2000, readlen=101)
    fa = tmp_path / "stream.fa"
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">s{i}\n{r.decode()}\n")
    with open(fa) as fh:
        blob = fh.read()
    big = tmp_path / "big.fa"
    with open(big, "w") as fh:
        for _ in range(30):
            fh.write(blob)
    clf = Classifier(db, tree)
    sink = io.StringIO()
    clf.process_dataset(str(fa), sink, batch_size=1024)  # compile
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    out = io.StringIO()
    clf.process_dataset(str(big), out, batch_size=1024)
    n_lines = out.getvalue().count("\n")
    del out
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert n_lines >= 30 * sum(1 for t in clf.classify_reads(reads) if t)
    # high-water growth during the 60k-read stream stays under 600 MB
    # (the stream itself is ~6 MB; queues hold <= 4 batches).  ru_maxrss
    # is KB on Linux, bytes on macOS.
    import sys as _sys

    unit = 1 if _sys.platform.startswith("linux") else 1024
    assert rss1 - rss0 < 600_000 * unit, (rss0, rss1)


def test_probe_image_roundtrip(db, tree, tmp_path):
    """A probe image (save_probe_image -> Classifier.from_probe_image)
    must classify byte-identically to the table-backed classifier: the
    image stores the SAME packed slot words the classifier would build
    (the khash memory-image analog, util.h:281-372)."""
    import io

    from bonsai_tpu.db.formats import save_probe_image

    rng = np.random.default_rng(44)
    reads = simulate_reads(rng, 1500, readlen=101)
    fa = tmp_path / "img.fa"
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">s{i}\n{r.decode()}\n")
    img_dir = tmp_path / "image"
    save_probe_image(str(img_dir), db, tree)

    ref = Classifier(db, tree, emit_all=True)
    a = io.StringIO()
    ref.process_dataset(str(fa), a, batch_size=512)

    clf = Classifier.from_probe_image(str(img_dir), tree, emit_all=True)
    b = io.StringIO()
    clf.process_dataset(str(fa), b, batch_size=512)
    assert a.getvalue() == b.getvalue()

    # wrong-tree loads must be refused (the image packs tree-compact
    # indices)
    other = TaxTree({1: 0, 2: 1, 3: 1})
    with pytest.raises(ValueError):
        Classifier.from_probe_image(str(img_dir), other)


def test_slow_writer_backpressure(db, tree, tmp_path):
    """When the OUTPUT side is the bottleneck (slow disk / pipe), the
    producer must not run ahead unboundedly: both pipeline queues are
    depth-bounded, so the number of batches prepared but not yet
    written stays <= 2*depth + the 3 in-hand batches (one per stage
    thread).  This is the behavioral form of the sustained-stream RSS
    bound (classifier.h:321 flushes per-chunk for
    the same reason)."""
    import io
    import threading
    import time as _time

    rng = np.random.default_rng(43)
    reads = simulate_reads(rng, 4000, readlen=101)
    fa = tmp_path / "bp.fa"
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">s{i}\n{r.decode()}\n")
    clf = Classifier(db, tree)
    lock = threading.Lock()
    outstanding = {"cur": 0, "max": 0}
    orig_prep = clf._prepare_batch
    orig_fin = clf._finish_batch

    def prep(batch, paired=False):
        with lock:
            outstanding["cur"] += 1
            outstanding["max"] = max(outstanding["max"], outstanding["cur"])
        return orig_prep(batch, paired)

    def fin(batch, out, paired=False, force_full=False):
        with lock:
            outstanding["cur"] -= 1
        return orig_fin(batch, out, paired, force_full)

    clf._prepare_batch = prep
    clf._finish_batch = fin

    class SlowSink(io.TextIOBase):
        def write(self, s):
            _time.sleep(0.03)
            return len(s)

    clf.process_dataset(str(fa), SlowSink(), batch_size=256)
    depth = 4  # BONSAI_TPU_PIPELINE_DEPTH default
    assert outstanding["max"] <= 2 * depth + 3, outstanding
    assert outstanding["cur"] == 0, outstanding
