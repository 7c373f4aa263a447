#!/usr/bin/env python
"""Scale chapter: 100M+-kmer builds, probe cost against table size, and
sharded classify at sizes BASELINE config 5 calls "10s of GB" (the
reference loads khash images of arbitrary size, util.h:281-372).

Subcommands
-----------
gen [--genomes N] [--mb M]      synthesize a corpus of N random genomes of
                                M Mb each under .bench_cache/scale/
build [--shards S|auto]         host streaming build (checkpointed) of the
                                corpus -> sharded DB dir; prints kmers/s
probe [--sizes 10,40,160]       device probe-step sweep vs table size
                                (millions of keys) — the measurement the
                                shard-size policy (db/formats.py
                                SHARD_SLOT_BUDGET) rests on
classify [--ndb K]              mesh from_sharded_dir classify of
  [--db-ranks R]                synthetic reads against the built DB
  [--stream-reads N]            (grouped ranks when R < K); checks
                                agreement vs direct table probes; with
                                --stream-reads also runs a full
                                process_dataset stream of N reads
rankload --ndb K [--rank S]     per-rank load cost of one shard (read +
                                place + encode — what from_sharded_dir
                                does per 'db' rank)
shardprobe --ndb K [--rank S]   device probe of one shard of the built DB
                                (per-device cost at the policy shard size)

`classify` takes the devices JAX finds; rehearse it on a virtual CPU mesh
with JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8.
All outputs print one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SCALE = os.path.join(REPO, ".bench_cache", "scale")
K = 31


def gen(n_genomes: int, mb: float, out_dir: str = SCALE,
        seed: int = 12345):
    """Seeded corpus of n_genomes uniform-random genomes of mb Mb each,
    one FASTA per genome named SYN_<i>.fa with accession SYN_<i>.1.  At
    k=31 random genomes share no k-mer (collisions are ~(N/4^31) per
    pair), so every k-mer's LCA is its own genome."""
    import bonsai_tpu  # noqa: F401

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    paths = []
    t0 = time.time()
    for g in range(n_genomes):
        p = os.path.join(out_dir, f"SYN_{g:04d}.fa")
        paths.append(p)
        if os.path.exists(p):
            continue
        L = int(mb * 1e6)
        seq = bases[rng.integers(0, 4, L)].tobytes()
        with open(p + ".tmp", "wb") as fh:
            fh.write(f">SYN_{g:04d}.1 synthetic\n".encode())
            for i in range(0, L, 80):
                fh.write(seq[i : i + 80] + b"\n")
        os.replace(p + ".tmp", p)
    print(
        json.dumps(
            dict(
                metric="scale_corpus",
                genomes=n_genomes,
                mb_each=mb,
                wall_s=round(time.time() - t0, 1),
            )
        )
    )
    return paths


def _corpus_paths():
    return sorted(
        os.path.join(SCALE, f)
        for f in os.listdir(SCALE)
        if f.startswith("SYN_") and f.endswith(".fa")
    )


def _tree_and_names(paths):
    from bonsai_tpu.taxonomy.tree import TaxTree

    tax = {1: 0, 2: 1}
    name_map = {}
    for i, p in enumerate(paths):
        tax[10 + i] = 2
        name_map[os.path.basename(p)[:-3] + ".1"] = 10 + i
    return TaxTree(tax), name_map


def do_build(shards: str, as_arrays: bool = False):
    import resource

    from bonsai_tpu.core.spacer import Spacer
    from bonsai_tpu.db.build import lca_map
    from bonsai_tpu.db.formats import (
        Database,
        recommended_shards,
        save_database_sharded,
        save_sharded_arrays,
        table_slot_bytes,
    )

    paths = _corpus_paths()
    assert paths, "run `gen` first"
    tree, name_map = _tree_and_names(paths)
    ck = os.path.join(SCALE, "build_ckpt.npz")
    t0 = time.time()
    if as_arrays:
        # config-5 scale path: sorted arrays only (no global placement),
        # sparse checkpoints (each one writes the full multi-GB state)
        keys, vals = lca_map(
            paths, tree, name_map, Spacer(K, K), canonicalize=True,
            checkpoint_path=ck, as_arrays=True, checkpoint_every_folds=4,
        )
        n = keys.size
    else:
        table = lca_map(
            paths, tree, name_map, Spacer(K, K), canonicalize=True,
            checkpoint_path=ck,
        )
        n = table.n
    build_s = time.time() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    if shards == "auto":
        ndb = recommended_shards(n)
    else:
        ndb = int(shards)
    d = os.path.join(SCALE, f"db_shards{ndb}")
    t1 = time.time()
    if as_arrays:
        save_sharded_arrays(keys, vals, d, ndb=ndb, k=K, w=K,
                            gaps=[0] * (K - 1))
    else:
        db = Database(table=table, k=K, w=K, gaps=[0] * (K - 1))
        save_database_sharded(db, d, ndb=ndb)
    save_s = time.time() - t1
    print(
        json.dumps(
            dict(
                metric="scale_build",
                kmers=int(n),
                build_s=round(build_s, 1),
                kmers_per_s=round(n / build_s, 1),
                shards=ndb,
                save_s=round(save_s, 1),
                peak_rss_gb=round(rss_gb, 2),
                slot_footprint_gb=round(
                    ndb * table_slot_bytes(-(-n // ndb)) / 1e9, 2
                ),
                dir=d,
            )
        )
    )
    if os.path.exists(ck):
        os.unlink(ck)


def do_rankload(ndb: int, rank: int = 0):
    """Per-rank load cost of ONE shard of a sharded dir: file read ->
    cuckoo placement -> probe-ready slot encode (exactly what
    from_sharded_dir does per 'db' rank; BASELINE config 5 'per-rank
    load')."""
    import resource

    from bonsai_tpu.db.formats import read_database_arrays
    from bonsai_tpu.db.table import KmerTable

    d = os.path.join(SCALE, f"db_shards{ndb}")
    with open(os.path.join(d, "manifest.json")) as fh:
        mf = json.load(fh)
    t0 = time.time()
    _, keys, vals = read_database_arrays(
        os.path.join(d, mf["shards"][rank])
    )
    read_s = time.time() - t0
    t1 = time.time()
    tbl = KmerTable(keys, vals, min_nb=int(mf["nb"]))
    place_s = time.time() - t1
    t2 = time.time()
    packed = (vals.astype(np.uint64) << np.uint64(32)) | np.uint64(1)
    slots, _, _ = tbl._encode_slots(packed)
    encode_s = time.time() - t2
    print(
        json.dumps(
            dict(
                metric="scale_rankload",
                ndb=ndb,
                rank=rank,
                keys=int(keys.size),
                read_s=round(read_s, 2),
                place_s=round(place_s, 2),
                encode_s=round(encode_s, 2),
                total_s=round(time.time() - t0, 2),
                slots_mb=round(slots.nbytes / 1e6, 1),
                peak_rss_gb=round(
                    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                    / 1e6, 2,
                ),
            )
        )
    )


def do_shardprobe(ndb: int, rank: int = 0):
    """Device probe of one shard file of the built DB (per-device cost
    at the policy shard size — BASELINE config 5's last leg)."""
    import jax
    import jax.numpy as jnp

    from bonsai_tpu.db.formats import read_database_arrays
    from bonsai_tpu.db.table import SLOTS, KmerTable

    d = os.path.join(SCALE, f"db_shards{ndb}")
    with open(os.path.join(d, "manifest.json")) as fh:
        mf = json.load(fh)
    _, keys, vals = read_database_arrays(
        os.path.join(d, mf["shards"][rank])
    )
    t = KmerTable(keys, vals, min_nb=int(mf["nb"]))
    slots, uniq, inline = t.device_arrays()
    rng = np.random.default_rng(0)
    B, P = 8192, 74
    Q = B * P
    qh = keys[rng.integers(0, keys.size, size=int(Q * 0.8))]
    qm = rng.integers(0, 1 << 62, size=Q - qh.size, dtype=np.uint64)
    q = np.concatenate([qh, qm])
    rng.shuffle(q)
    jq = jnp.asarray(q)
    n_steps = 15
    dt = _time_probe(jq, slots, uniq, inline, t.lgnb, t.vbits, n_steps)
    print(
        json.dumps(
            dict(
                metric="scale_shardprobe",
                ndb=ndb,
                rank=rank,
                keys=int(keys.size),
                slots_mb=round(t.nb * SLOTS * 8 / 1e6, 1),
                ns_per_probe=round(dt / n_steps / Q * 1e9, 2),
                reads_per_s_equiv=round(B / (dt / n_steps), 1),
                platform=jax.devices()[0].platform,
                device_kind=jax.devices()[0].device_kind,
            )
        )
    )


def _time_probe(jq, slots, uniq, inline, lgnb, vbits, n_steps):
    """Seconds for n_steps probes of the query batch jq, after warm-up,
    each ended with block_until_ready."""
    import jax

    from bonsai_tpu.db.table import probe_slots_device

    @jax.jit
    def step(jq, slots, uniq):
        return probe_slots_device(jq, slots, uniq, inline, lgnb, vbits)

    for _ in range(3):  # compile + warm
        jax.block_until_ready(step(jq, slots, uniq))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        jax.block_until_ready(step(jq, slots, uniq))
    return time.perf_counter() - t0


def do_probe(sizes_m):
    """Classify-shaped probe throughput vs single-device table size
    (synthetic keys, ~80% hits).  One row per size: ns per probe and the
    table's slot-array bytes."""
    import jax
    import jax.numpy as jnp

    from bonsai_tpu.db.build import unique_u64
    from bonsai_tpu.db.table import SLOTS, KmerTable

    rng = np.random.default_rng(0)
    B, P = 8192, 74  # HiSeq-shaped query volume per step
    Q = B * P
    n_steps = 15
    rows = []
    for m in sizes_m:
        n = int(m * 1e6)
        # native sort-dedup: some numpy builds' np.unique takes minutes
        # on 10^8 distinct u64
        keys = unique_u64(
            rng.integers(0, 1 << 62, size=int(n * 1.02), dtype=np.uint64)
        )[:n]
        vals = rng.integers(1, 7, size=n).astype(np.uint32)
        t = KmerTable(keys, vals)
        slots, uniq, inline = t.device_arrays()
        # ~80% hits, like real reads against their source DB
        qh = keys[rng.integers(0, n, size=int(Q * 0.8))]
        qm = rng.integers(0, 1 << 62, size=Q - qh.size, dtype=np.uint64)
        q = np.concatenate([qh, qm])
        rng.shuffle(q)
        jq = jnp.asarray(q)
        dt = _time_probe(jq, slots, uniq, inline, t.lgnb, t.vbits, n_steps)
        row = dict(
            metric="scale_probe",
            keys_m=m,
            table_mb=round(t.nb * SLOTS * 8 / 1e6, 1),
            ns_per_probe=dt / n_steps / Q * 1e9,
            reads_per_s_equiv=B / (dt / n_steps),
            platform=jax.devices()[0].platform,
            device_kind=jax.devices()[0].device_kind,
        )
        rows.append(row)
        print(json.dumps(row), flush=True)
        del slots, uniq, jq
    return rows


def do_classify(ndb: int, db_ranks: int | None = None,
                stream_reads: int = 0):
    """Mesh classify at scale on the devices JAX finds: per-rank lazy
    shard load + a2a routed probe on synthetic reads drawn from the
    corpus.  db_ranks < ndb exercises the grouped loader (a mesh narrower
    than the shard count); stream_reads adds a full process_dataset
    stream with agreement checked against direct host probes of the
    shard tables."""
    db_ranks = db_ranks or ndb
    import bonsai_tpu  # noqa: F401
    import jax

    from bonsai_tpu.classify import output as out_mod
    from bonsai_tpu.io import fastx
    from bonsai_tpu.parallel.mesh import make_mesh
    from bonsai_tpu.parallel.sharded import ShardedClassifier

    paths = _corpus_paths()
    tree, name_map = _tree_and_names(paths)
    d = os.path.join(SCALE, f"db_shards{ndb}")
    assert os.path.exists(d), f"run `build --shards {ndb}` first"
    mesh = make_mesh({"dp": 1, "db": db_ranks})
    t0 = time.time()
    sc = ShardedClassifier.from_sharded_dir(d, tree, mesh)
    load_s = time.time() - t0
    # reads sampled from genome 0 and genome ndb%len (hits) + random
    rng = np.random.default_rng(1)
    with open(paths[0], "rb") as fh:
        fh.readline()
        g0 = fh.read().replace(b"\n", b"")
    reads = []
    for i in range(512):
        s = int(rng.integers(0, len(g0) - 101))
        reads.append(g0[s : s + 101])
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i in range(128):
        reads.append(bases[rng.integers(0, 4, 101)].tobytes())
    codes = np.full((len(reads), 101), -1, dtype=np.int8)
    for i, r in enumerate(reads):
        codes[i] = sc.lut[np.frombuffer(r, dtype=np.uint8)]
    batch = fastx.ReadBatch(
        names=[f"r{i}".encode() for i in range(len(reads))], seqs=reads,
        codes=codes, lengths=np.full(len(reads), 101, np.int32),
        quals=[None] * len(reads),
    )
    t0 = time.time()
    res = sc._finish_batch(batch, sc._dispatch_batch(batch))
    step_s = time.time() - t0
    taxon = res.taxon
    # genome-0 reads must resolve to taxid 10 (its leaf); random reads
    # against random-DNA genomes can collide only at ~(1 - (1-2^-62)^P)
    ok0 = int((taxon[:512] == 10).sum())
    okr = int((taxon[512:] == 0).sum())
    print(
        json.dumps(
            dict(
                metric="scale_classify",
                ndb=ndb,
                db_ranks=db_ranks,
                load_s=round(load_s, 1),
                first_batch_s=round(step_s, 1),
                genome_reads_correct=f"{ok0}/512",
                random_reads_unclassified=f"{okr}/128",
            )
        ),
        flush=True,
    )
    assert ok0 == 512 and okr == 128

    if stream_reads:
        # the multi-million-read STREAM (BASELINE config 5): synthesize
        # a read file sampled across the whole corpus + noise, stream it
        # through process_dataset on the virtual mesh, and verify a
        # sample of per-read taxids against direct host probes of the
        # shard tables (the non-mesh ground truth)
        import io

        rf = os.path.join(SCALE, f"stream_{stream_reads}.fa")
        per_g = max(stream_reads // max(len(paths), 1), 1)
        n_reads_file = per_g * len(paths)
        if not os.path.exists(rf):
            with open(rf + ".tmp", "w") as fh:
                widx = 0
                for gpath in paths:
                    with open(gpath, "rb") as gh:
                        gh.readline()
                        gg = gh.read().replace(b"\n", b"")
                    pos = rng.integers(0, len(gg) - 101, size=per_g)
                    for s0 in pos:
                        fh.write(
                            f">w{widx}\n"
                            + gg[int(s0):int(s0) + 101].decode() + "\n"
                        )
                        widx += 1
            os.replace(rf + ".tmp", rf)
        n_lines = [0]

        class _Count(io.TextIOBase):
            def write(self, s):
                n_lines[0] += s.count("\n")
                return len(s)

        t0 = time.time()
        sc.process_dataset(rf, _Count(), batch_size=8192)
        stream_s = time.time() - t0
        # agreement sample: classify 2k reads via the mesh and compare
        # their LEAF taxid against direct probes (reads are error-free
        # slices of one genome, so every kmer maps to one leaf or a fold)
        sample = []
        for i, (name, seq, _) in enumerate(fastx.read_fastx(rf)):
            sample.append(seq)
            if len(sample) >= 2048:
                break
        codes = np.full((len(sample), 101), -1, dtype=np.int8)
        for i, r in enumerate(sample):
            codes[i] = sc.lut[np.frombuffer(r, dtype=np.uint8)]
        sb = fastx.ReadBatch(
            names=[f"s{i}".encode() for i in range(len(sample))],
            seqs=sample, codes=codes,
            lengths=np.full(len(sample), 101, np.int32),
            quals=[None] * len(sample),
        )
        res = sc._finish_batch(sb, sc._dispatch_batch(sb))
        from bonsai_tpu.core import bitops, encode as enc_mod
        from bonsai_tpu.db.formats import read_database_arrays
        from bonsai_tpu.db.table import shard_owner

        # direct ground truth WITHOUT loading the whole DB: binary-search
        # every sample kmer in its owner shard's sorted key file, one
        # shard at a time (bounded RAM at any DB size)
        with open(os.path.join(d, "manifest.json")) as fh:
            mfndb = json.load(fh)["ndb"]
        qs, qread = [], []
        for i, seq in enumerate(sample):
            km, inv = enc_mod.pack_kmers(
                sc.lut[np.frombuffer(seq, np.uint8)][None], K
            )
            q = bitops.canonical(km[~inv], K)
            qs.append(q)
            qread.append(np.full(q.size, i, np.int32))
        qs = np.concatenate(qs)
        qread = np.concatenate(qread)
        qv = np.zeros(qs.size, np.uint32)
        qf = np.zeros(qs.size, bool)
        own = shard_owner(qs, mfndb)
        for s in range(mfndb):
            sel = np.nonzero(own == s)[0]
            if not sel.size:
                continue
            _, skeys, svals = read_database_arrays(
                os.path.join(d, f"shard-{s:05d}.btpu")
            )
            pos = np.searchsorted(skeys, qs[sel])
            pc = np.clip(pos, 0, max(skeys.size - 1, 0))
            hit = (skeys.size > 0) & (skeys[pc] == qs[sel])
            qf[sel] = hit
            qv[sel[hit]] = svals[pc[hit]]
        agree = 0
        for i in range(len(sample)):
            m = qread == i
            v, f = qv[m], qf[m]
            want = 0
            if f.any():
                vv = np.unique(v[f])
                leaves = vv[vv >= 10]
                # a read is a slice of ONE genome: its kmers map to that
                # leaf or (for cross-genome shared keys) the fold taxid 2;
                # the root-to-leaf path score always prefers the leaf when
                # any leaf kmer hit
                want = int(leaves[0]) if leaves.size else 2
            agree += int(int(res.taxon[i]) == want)
        print(
            json.dumps(
                dict(
                    metric="scale_stream",
                    ndb=ndb,
                    db_ranks=db_ranks,
                    reads=n_reads_file,
                    lines=n_lines[0],
                    stream_s=round(stream_s, 1),
                    reads_per_s=round(n_reads_file / stream_s, 1),
                    sample_agree=f"{agree}/{len(sample)}",
                )
            ),
            flush=True,
        )
        assert agree == len(sample), "mesh classify != direct probes"


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen")
    g.add_argument("--genomes", type=int, default=22)
    g.add_argument("--mb", type=float, default=5.0)
    b = sub.add_parser("build")
    b.add_argument("--shards", default="auto")
    b.add_argument("--arrays", action="store_true",
                   help="config-5 path: sorted arrays + streaming "
                        "sharded save, no global placement")
    p = sub.add_parser("probe")
    p.add_argument("--sizes", default="10,40,160")
    c = sub.add_parser("classify")
    c.add_argument("--ndb", type=int, default=8)
    c.add_argument("--db-ranks", type=int, default=0,
                   help="mesh 'db' width (0 = ndb); < ndb groups "
                        "consecutive shard files per rank")
    c.add_argument("--stream-reads", type=int, default=0,
                   help="also run a full process_dataset stream of this "
                        "many synthetic reads (reads/s + agreement vs "
                        "direct table probes on a sample)")
    r = sub.add_parser("rankload")
    r.add_argument("--ndb", type=int, required=True)
    r.add_argument("--rank", type=int, default=0)
    s = sub.add_parser("shardprobe")
    s.add_argument("--ndb", type=int, required=True)
    s.add_argument("--rank", type=int, default=0)
    args = ap.parse_args()
    if args.cmd == "gen":
        gen(args.genomes, args.mb)
    elif args.cmd == "build":
        do_build(args.shards, as_arrays=args.arrays)
    elif args.cmd == "probe":
        do_probe([float(s) for s in args.sizes.split(",")])
    elif args.cmd == "classify":
        do_classify(args.ndb, db_ranks=args.db_ranks or None,
                    stream_reads=args.stream_reads)
    elif args.cmd == "rankload":
        do_rankload(args.ndb, args.rank)
    elif args.cmd == "shardprobe":
        do_shardprobe(args.ndb, args.rank)


if __name__ == "__main__":
    main()
