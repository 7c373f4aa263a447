"""Command-line interface mirroring the reference `bonsai` subcommands
(/root/reference/bin/bonsai.cpp:521-540): classify, build/phase2,
prebuild/phase1, hist, plus the standalone lca/taxmap tools
(bin/lca.cpp, bin/taxmap.cpp).  Flags mirror the reference getopt strings
1:1 where they exist (-k, -w, -S spacing, -e/-t/-f minimization mode, -C
no-canonicalize, -T nodes.dmp, -M nameidmap, -z gzip, -F paths-file, -o out).
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np


def _add_classify(sub):
    p = sub.add_parser("classify", help="classify reads against a database")
    p.add_argument("db")
    p.add_argument("tax_path")
    p.add_argument("reads")
    p.add_argument("mate", nargs="?", default=None)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-c", "--chunk-size", type=int, default=4096)
    p.add_argument("-a", "--emit-all", action="store_true")
    p.add_argument("-k", "--kraken", dest="kraken", action="store_true", default=True)
    p.add_argument("-K", "--no-kraken", dest="kraken", action="store_false")
    p.add_argument("-f", "--fastq", action="store_true")
    p.add_argument("-C", "--no-canon", action="store_true")
    p.add_argument("--db-shards", type=int, default=0,
                   help="shard the table over a 'db' mesh axis across "
                        "devices (0 = single-device pipeline)")
    p.add_argument("--route", default="auto",
                   choices=["auto", "a2a", "psum"],
                   help="sharded-probe strategy: a2a = all_to_all routed "
                        "(per-chip gather volume flat in shard count, "
                        "default); psum = range-sharded merge")
    p.add_argument("--distributed", action="store_true",
                   help="join the multi-host runtime first "
                        "(set JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/"
                        "JAX_PROCESS_ID)")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage wall times (parse/dispatch/"
                        "materialize/format) to stderr")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace of the run here")
    return p


def _add_build(sub, name, aliases):
    p = sub.add_parser(name, aliases=aliases, help="build phase-2 (classify) database")
    p.add_argument("out_path")
    p.add_argument("paths", nargs="*")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-w", type=int, default=-1)
    p.add_argument("-S", "--spacing", default="")
    p.add_argument("-T", "--tax-path", required=True, help="nodes.dmp")
    p.add_argument("-M", "--seq2tax", required=True, help="name<TAB>taxid map")
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-C", "--no-canon", action="store_true")
    p.add_argument("-e", "--entropy", action="store_true", help="entropy minimization")
    p.add_argument("-t", "--tax-depth", action="store_true", help="phase1-driven, tax-depth scores")
    p.add_argument("-f", "--feature-count", action="store_true", help="phase1-driven, feature-count scores")
    p.add_argument("-z", "--gzip", action="store_true")
    p.add_argument("--phase1-db", default=None, help="phase-1 DB for -t/-f modes")
    p.add_argument("--bonsai-format", action="store_true", help="write reference khash format")
    p.add_argument("--device-build", action="store_true",
                   help="run the k-mer fold on the accelerator "
                        "(db/build_device.py sort-based pipeline)")
    p.add_argument("--shards", default="0", metavar="N|auto",
                   help="write OUT_PATH as a DIRECTORY of N hash-prefix "
                        "shard files + manifest (each host loads only "
                        "its 'db'-rank shards; partition matches the "
                        "all_to_all routed probe).  'auto' picks the "
                        "smallest count keeping each rank's slot array "
                        "inside the measured per-device budget "
                        "(db/formats.py recommended_shards)")
    return p


def _add_prebuild(sub):
    p = sub.add_parser("prebuild", aliases=["p1", "phase1"], help="build phase-1 score map")
    p.add_argument("seq2tax")
    p.add_argument("tax_path")
    p.add_argument("out_path")
    p.add_argument("paths", nargs="*")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-S", "--spacing", default="")
    p.add_argument("-C", "--no-canon", action="store_true")
    p.add_argument("-t", "--tax-depth", action="store_true")
    p.add_argument("-f", "--feature-count", action="store_true")
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("--device-build", action="store_true",
                   help="run the k-mer fold on the accelerator "
                        "(db/build_device.py sort-based pipeline)")
    return p


def _paths(args) -> List[str]:
    if getattr(args, "paths_file", None):
        with open(args.paths_file) as fh:
            return [l.strip() for l in fh if l.strip()]
    return list(args.paths)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bonsai-tpu")
    ap.add_argument("-v", "--version", action="store_true")
    sub = ap.add_subparsers(dest="cmd")
    _add_classify(sub)
    _add_build(sub, "build", ["p2", "phase2"])
    _add_prebuild(sub)

    p = sub.add_parser("hist", help="taxid -> kmer-count histogram of a database")
    p.add_argument("db")
    p.add_argument("out", nargs="?", default=None)

    p = sub.add_parser(
        "probe-image",
        help="bake a classify-ready memory image for (db, taxonomy): "
             "later `classify IMAGE_DIR ...` mmaps + uploads it with no "
             "table rebuild (the khash-memory-image analog, "
             "util.h:281-372)",
    )
    p.add_argument("db")
    p.add_argument("tax_path")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--db-ranks", type=int, default=0,
                   help="sharded-dir DBs: bake PER-RANK images for this "
                        "mesh width (0 = one per shard file); images "
                        "land inside the DB dir and from_sharded_dir "
                        "picks them up automatically")

    p = sub.add_parser(
        "merge-parts",
        help="reassemble per-rank output files from a multi-host "
             "`classify --distributed -o DIR` run into the exact "
             "single-process stream",
    )
    p.add_argument("parts_dir")
    p.add_argument("-o", "--out", default=None, help="default: stdout")

    p = sub.add_parser("lca", help="LCA of taxids")
    p.add_argument("tax_path")
    p.add_argument("taxids", nargs="+", type=int)

    p = sub.add_parser("taxmap", help="build + save a name->taxid map")
    p.add_argument("nameidmap")
    p.add_argument("out")

    p = sub.add_parser(
        "kmercnt", help="multi-k kmer counting -> .shs/.bin dumps (bin/kmercnt.cpp)"
    )
    p.add_argument("paths", nargs="+")
    p.add_argument("-k", "--ks", default="31", help="comma-separated k values")
    p.add_argument("-o", "--out-prefix", default=None, help="default: input path")
    p.add_argument("-C", "--canon", action="store_true")
    p.add_argument("--shs-only", action="store_true")
    p.add_argument("--bin-only", action="store_true")
    p.add_argument("--nthash", action="store_true",
                   help="ntHash NTC64 backend (reference kmercnt -htype 2)")

    p = sub.add_parser(
        "setsketch", aliases=["setsketcher"],
        help="per-file continuous SetSketch + union (bin/setsketcher.cpp)",
    )
    p.add_argument("paths", nargs="*")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-o", "--out", default="default.sketch")
    p.add_argument("-z", "--sketch-size", type=int, default=4096)
    p.add_argument("-C", "--no-canon", action="store_true")
    p.add_argument("-s", "--save-kmer-counts", action="store_true")
    p.add_argument("-S", "--save-kmers", action="store_true")
    p.add_argument("-Z", "--no-per-file", action="store_true")
    p.add_argument("-B", "--basename", action="store_true")
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-c", "--cyclic", action="store_true",
                   help="rolling cyclic hash instead of 2-bit kmers")
    p.add_argument("-P", "--protein", action="store_true",
                   help="protein k-mers (implies cyclic hashing, "
                        "setsketcher.cpp:125-128)")

    p = sub.add_parser("cmpshs", help="pairwise compare .shs dumps (bin/cmpshs.cpp)")
    p.add_argument("paths", nargs="+")
    p.add_argument("-m", "--metric", default="jaccard",
                   choices=["jaccard", "intersection", "union", "containment"])
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser("css2ss", help="continuous -> packed setsketch (bin/css2ss.cpp)")
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("-b", "--bits", type=int, default=16)

    p = sub.add_parser(
        "shs2sketch", help="sorted-hash-set dump -> setsketch (bin/shs2sketch.cpp)"
    )
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("-z", "--sketch-size", type=int, default=4096)
    p.add_argument("-b", "--bits", type=int, default=16)

    p = sub.add_parser(
        "ssi-build", aliases=["setsketchindexer"],
        help="build an LSH index over packed setsketches (bin/setsketchindexer.cpp)",
    )
    p.add_argument("sketches", nargs="+")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-r", "--regs-per-hash", type=int, default=4)
    p.add_argument("-k", type=int, default=0)

    p = sub.add_parser(
        "ssi-screen", aliases=["setsketchscreener"],
        help="screen query sketches against an LSH index (bin/setsketchscreener.cpp)",
    )
    p.add_argument("index")
    p.add_argument("queries", nargs="+")
    p.add_argument("-n", "--topn", type=int, default=10)
    p.add_argument("-r", "--regs-per-hash", type=int, default=4)

    p = sub.add_parser(
        "genome2multiset",
        help="genome -> kmer multiset .bin dump (bin/genome2multiset.cpp)",
    )
    p.add_argument("path")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-o", "--out-prefix", default=None)
    p.add_argument("-C", "--canon", action="store_true")

    p = sub.add_parser("fahist", help="sequence-length histogram (bin/fahist.cpp)")
    p.add_argument("paths", nargs="+")
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser(
        "kmeridx", help="build a positional kmer index (bin/kmeridx.cpp)"
    )
    p.add_argument("path")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-o", "--out", required=True)

    p = sub.add_parser(
        "stdin2ss",
        help="raw u64 stream -> packed setsketch (bin/stdin2ss.cpp)",
    )
    p.add_argument("inp", nargs="?", default=None, help="default: stdin")
    p.add_argument("-S", "--sketch-size", type=int, default=1000)
    p.add_argument("-a", type=float, default=-1.0)
    p.add_argument("-b", type=float, default=-1.0)
    p.add_argument("-H", "--use-short", action="store_true",
                   help="16-bit registers instead of 8-bit")
    p.add_argument("-o", "--out", default=None)

    p = sub.add_parser(
        "setsketchroller",
        help="build an inverted kmer->samples db from .kmers dumps "
             "(bin/setsketchroller.cpp)",
    )
    p.add_argument("kmer_files", nargs="*")
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-k", type=int, default=0)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-b", "--trim-folder", action="store_true")

    p = sub.add_parser(
        "errexp",
        help="sketch accuracy experiment: HLL vs CSetSketch jaccard error "
             "(bin/errexp.cpp)",
    )
    p.add_argument("-l", "--linspace", type=float, default=0.1)
    p.add_argument("--set-sizes", default="16,18,20")
    p.add_argument("--sketch-sizes", default="8,10,12")

    p = sub.add_parser(
        "metatree",
        help="data-driven taxonomy restructuring (bin/bonsai.cpp:410-518)",
    )
    p.add_argument("tax_path", help="nodes.dmp")
    p.add_argument("nameidmap")
    p.add_argument("paths", nargs="*")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-F", "--paths-file", default=None)
    p.add_argument("-L", "--accept-lca", type=int, action="append", default=[])
    p.add_argument("-n", "--nelem", type=int, default=0,
                   help="nodes to emit (default roundup64(|tax|)-|tax|)")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-C", "--no-canon", action="store_true")

    p = sub.add_parser(
        "distmat",
        help="genomes -> pairwise distance matrix (.tsv + .npy), the "
             "run_dist.py + distmat2np.py workflow (python/run_dist.py)",
    )
    p.add_argument("paths", nargs="+")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-o", "--out", required=True,
                   help="output prefix (writes PREFIX.tsv, PREFIX.npy, "
                   "PREFIX.labels.txt)")
    p.add_argument("--metric", default="jaccard",
                   choices=["jaccard", "intersection", "union",
                            "containment", "mash"])
    p.add_argument("--hll", type=int, metavar="P", default=0,
                   help="estimate with HyperLogLog(p=P) sketches instead "
                   "of exact sets (run_dist's sketch mode)")
    p.add_argument("-C", "--no-canon", action="store_true")

    p = sub.add_parser(
        "rolling-multk", aliases=["rolling_multk"],
        help="multi-k rolling-hash distinct counts (bin/rolling_multk.cpp)",
    )
    p.add_argument("paths", nargs="+")
    p.add_argument("-k", "--ks", default="17,21,25,29,31")
    p.add_argument("-C", "--canon", action="store_true")

    p = sub.add_parser(
        "rolling-multk-sketch", aliases=["rolling_multk_sketch"],
        help="per-k CSetSketch over a rolling multi-k ladder "
             "(bin/rolling_multk_sketch.cpp)",
    )
    p.add_argument("paths", nargs="+")
    p.add_argument("-k", "--ks", default="17,21,25,29,31")
    p.add_argument("-z", "--sketch-size", type=int, default=1024)
    p.add_argument("-C", "--canon", action="store_true")
    p.add_argument("-o", "--out-prefix", default=None)

    args = ap.parse_args(argv)
    if args.version:
        from . import __version__

        print(f"bonsai-tpu|{__version__}")
        return 0
    if args.cmd is None:
        ap.print_help()
        return 1
    aliases = {
        "p2": "build", "phase2": "build",
        "p1": "prebuild", "phase1": "prebuild",
        "setsketcher": "setsketch",
        "setsketchindexer": "ssi-build",
        "setsketchscreener": "ssi-screen",
        "rolling_multk": "rolling-multk",
        "rolling_multk_sketch": "rolling-multk-sketch",
    }
    cmd = aliases.get(args.cmd, args.cmd).replace("-", "_")
    return globals()[f"_cmd_{cmd}"](args)


def _cmd_classify(args):
    from .classify.pipeline import Classifier
    from .db.formats import load_database, import_bonsai_database
    from .taxonomy.tree import TaxTree

    import os

    db = None
    if os.path.isdir(args.db):
        meta_p = os.path.join(args.db, "meta.json")
        if os.path.exists(meta_p):
            import json as _json

            with open(meta_p) as fh:
                is_image = (
                    _json.load(fh).get("format") == "btpu-probe-image"
                )
            if is_image and not args.db_shards:
                # classify-ready memory image: mmap + upload, no table
                # rebuild (probe-image subcommand; util.h:281-372)
                tree = TaxTree.from_nodes_dmp(args.tax_path)
                clf = Classifier.from_probe_image(
                    args.db, tree, emit_all=args.emit_all,
                    emit_kraken=args.kraken, emit_fastq=args.fastq,
                )
                out = open(args.out, "w") if args.out else sys.stdout
                try:
                    clf.process_dataset(
                        args.reads, out, mate_path=args.mate,
                        batch_size=args.chunk_size, profile=args.profile,
                    )
                finally:
                    if args.out:
                        out.close()
                print(
                    f"classified: {clf.n_classified}  "
                    f"unclassified: {clf.n_unclassified}",
                    file=sys.stderr,
                )
                return 0
        from .db.formats import load_database_sharded

        if not args.db_shards:
            db = load_database_sharded(args.db)
    else:
        try:
            db = load_database(args.db)
        except ValueError:
            db = import_bonsai_database(args.db)
    tree = TaxTree.from_nodes_dmp(args.tax_path)
    if args.distributed:
        from .parallel.mesh import init_distributed

        init_distributed()
    if args.db_shards:
        from .parallel.mesh import default_mesh
        from .parallel.sharded import ShardedClassifier

        mesh = default_mesh(db_shards=args.db_shards)
        if db is None:
            # sharded DB directory + sharded mesh: each process loads
            # only its addressable 'db' ranks' shard files
            clf = ShardedClassifier.from_sharded_dir(
                args.db, tree, mesh, canonicalize=not args.no_canon,
                emit_all=args.emit_all, emit_kraken=args.kraken,
                emit_fastq=args.fastq,
            )
        else:
            clf = ShardedClassifier(db, tree, mesh,
                                    canonicalize=not args.no_canon,
                                    route=args.route,
                                    emit_all=args.emit_all,
                                    emit_kraken=args.kraken,
                                    emit_fastq=args.fastq)
        import jax

        if jax.process_count() > 1:
            # multi-host run: per-rank output files (no host gather);
            # -o names the parts DIRECTORY.  Reassemble the exact
            # single-process stream with `bonsai_tpu merge-parts DIR`.
            if not args.out:
                print("--distributed multi-host classify needs -o DIR",
                      file=sys.stderr)
                return 2
            if args.profile:
                print("--profile is not supported with multi-host "
                      "--distributed classify (per-rank pipeline)",
                      file=sys.stderr)
            n = clf.process_dataset_distributed(
                args.reads, args.out, mate_path=args.mate,
                batch_size=args.chunk_size,
            )
            print(
                f"[proc {jax.process_index()}] wrote {n} rows to "
                f"{args.out}/part-{jax.process_index():05d}.tsv "
                f"(classified: {clf.n_classified}  "
                f"unclassified: {clf.n_unclassified})",
                file=sys.stderr,
            )
            return 0
        out = open(args.out, "w") if args.out else sys.stdout
        try:
            clf.process_dataset(args.reads, out, mate_path=args.mate,
                                batch_size=args.chunk_size,
                                profile=args.profile)
        finally:
            if args.out:
                out.close()
        print(
            f"classified: {clf.n_classified}  "
            f"unclassified: {clf.n_unclassified}",
            file=sys.stderr,
        )
        return 0
    clf = Classifier(
        db,
        tree,
        canonicalize=not args.no_canon,
        emit_all=args.emit_all,
        emit_kraken=args.kraken,
        emit_fastq=args.fastq,
    )
    import contextlib

    trace_ctx = contextlib.nullcontext()
    if args.trace_dir:
        import jax.profiler

        trace_ctx = jax.profiler.trace(args.trace_dir)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        with trace_ctx:
            clf.process_dataset(args.reads, out, mate_path=args.mate,
                                batch_size=args.chunk_size,
                                profile=args.profile)
    finally:
        if args.out:
            out.close()
    print(
        f"classified: {clf.n_classified}  unclassified: {clf.n_unclassified}",
        file=sys.stderr,
    )
    return 0


def _cmd_build(args):
    from .core.spacer import Spacer, parse_spacing
    from .db.build import lca_map, minimized_map
    from .db.formats import Database, save_database, write_bonsai_database, load_database, import_bonsai_database
    from .taxonomy.tree import TaxTree

    k = args.k
    w = max(args.w, k)
    gaps = parse_spacing(args.spacing, k)
    sp = Spacer(k, w, gaps)
    tree = TaxTree.from_nodes_dmp(args.tax_path)
    paths = _paths(args)
    if not paths:
        print("no input genomes", file=sys.stderr)
        return 1
    canon = not args.no_canon
    if args.tax_depth or args.feature_count:
        if not args.phase1_db:
            print("-t/-f build requires --phase1-db", file=sys.stderr)
            return 1
        try:
            p1 = load_database(args.phase1_db)
        except ValueError:
            p1 = import_bonsai_database(args.phase1_db)
        if args.device_build:
            from .db.build_device import device_minimized_map

            table = device_minimized_map(paths, p1.table, tree,
                                         args.seq2tax, sp, canon)
        else:
            table = minimized_map(paths, p1.table, tree, args.seq2tax, sp,
                                  canon)
        scheme = "hash"
    else:
        # `bonsai build -e` reaches entropy scoring through the FILE
        # overload's generic windowed loops (ent_score eps 1e-4), not the
        # fused string-overload path — see core/encoder.py docstring.
        scheme = "entropy-file" if args.entropy else "lex"
        if args.device_build:
            from .db.build_device import device_lca_map

            table = device_lca_map(paths, tree, args.seq2tax, sp, canon,
                                   scheme)
        else:
            table = lca_map(paths, tree, args.seq2tax, sp, canon, scheme)
    db = Database(table=table, k=k, w=w, gaps=gaps, canonicalize=canon, scheme=scheme)
    n_shards = (
        0 if args.shards in ("0", 0)
        else args.shards if isinstance(args.shards, int)
        else None if args.shards == "auto" else int(args.shards)
    )
    if n_shards is None:
        from .db.formats import recommended_shards

        n_shards = recommended_shards(table.n)
        print(f"--shards auto -> {n_shards}", file=sys.stderr)
    if n_shards:
        from .db.formats import save_database_sharded

        save_database_sharded(db, args.out_path, n_shards,
                              compress="gz" if args.gzip else None)
    elif args.bonsai_format:
        write_bonsai_database(db, args.out_path, compress=args.gzip)
    else:
        save_database(db, args.out_path, compress="gz" if args.gzip else None)
    print(f"wrote {len(table)} kmers to {args.out_path}", file=sys.stderr)
    return 0


def _cmd_prebuild(args):
    from .core.spacer import Spacer, parse_spacing
    from .db.build import taxdepth_map, ftct_map
    from .db.formats import Database, save_database
    from .taxonomy.tree import TaxTree

    k = args.k
    gaps = parse_spacing(args.spacing, k)
    sp = Spacer(k, k, gaps)
    tree = TaxTree.from_nodes_dmp(args.tax_path)
    paths = _paths(args)
    canon = not args.no_canon
    if args.device_build:
        from .db.build_device import device_ftct_map, device_taxdepth_map

        build_ftct, build_td = device_ftct_map, device_taxdepth_map
    else:
        build_ftct, build_td = ftct_map, taxdepth_map
    if args.feature_count:
        table = build_ftct(paths, tree, args.seq2tax, sp, canon)
        scheme = "feature_count"
    else:
        table = build_td(paths, tree, args.seq2tax, sp, canon)
        scheme = "tax_depth"
    db = Database(table=table, k=k, w=k, gaps=gaps, canonicalize=canon, scheme=scheme)
    save_database(db, args.out_path)
    print(f"wrote {len(table)} kmers to {args.out_path}", file=sys.stderr)
    return 0


def _cmd_probe_image(args):
    import os

    from .db.formats import load_database, save_probe_image
    from .taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(args.tax_path)
    if os.path.isdir(args.db) and os.path.exists(
        os.path.join(args.db, "manifest.json")
    ):
        from .parallel.sharded import bake_rank_images

        out = bake_rank_images(args.db, tree, args.db_ranks)
        print(f"baked per-rank images under {out}", file=sys.stderr)
        return 0
    if not args.out_dir:
        print("probe-image of a .btpu file needs OUT_DIR", file=sys.stderr)
        return 2
    db = load_database(args.db)
    save_probe_image(args.out_dir, db, tree)
    print(f"wrote probe image for {db.table.n} kmers to {args.out_dir}",
          file=sys.stderr)
    return 0


def _cmd_merge_parts(args):
    from .parallel.sharded import merge_distributed_output

    out = open(args.out, "w", encoding="utf-8") if args.out else sys.stdout
    try:
        n = merge_distributed_output(args.parts_dir, out)
    finally:
        if args.out:
            out.close()
    print(f"merged {n} bytes from {args.parts_dir}", file=sys.stderr)
    return 0


def _cmd_hist(args):
    """Histogram of kmers per taxid (bin/bonsai.cpp:351-374)."""
    import os

    from .db.formats import (
        import_bonsai_database, load_database, load_database_sharded,
    )

    if os.path.isdir(args.db):
        db = load_database_sharded(args.db)
    else:
        try:
            db = load_database(args.db)
        except ValueError:
            db = import_bonsai_database(args.db)
    vals, counts = np.unique(db.table.vals_sorted, return_counts=True)
    order = np.argsort(counts, kind="stable")
    out = open(args.out, "w") if args.out else sys.stdout
    out.write("Name\tCount\n")
    for i in order:
        out.write(f"{vals[i]}\t{counts[i]}\n")
    if args.out:
        out.close()
    return 0


def _cmd_lca(args):
    from .taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(args.tax_path)
    acc = args.taxids[0]
    for t in args.taxids[1:]:
        acc = tree.lca(acc, t)
    print(acc)
    return 0


def _cmd_taxmap(args):
    import json

    from .taxonomy.ncbi import parse_nameid_map

    nm = parse_nameid_map(args.nameidmap)
    with open(args.out, "w") as fh:
        json.dump(nm, fh)
    print(f"wrote {len(nm)} names", file=sys.stderr)
    return 0


def _cmd_kmercnt(args):
    from .sketch import shs as shs_mod

    ks = [int(x) for x in args.ks.split(",")]
    flag = 0
    if not args.bin_only:
        flag |= shs_mod.WRITE_SHS
    if not args.shs_only:
        flag |= shs_mod.WRITE_KVMAP
    for path in args.paths:
        prefix = args.out_prefix or path
        written = shs_mod.dump_maps(prefix, ks, path, canon=args.canon,
                                    flag=flag, nthash=args.nthash)
        print("\n".join(written), file=sys.stderr)
    return 0


def _cmd_setsketch(args):
    import os

    from .core.alphabet import AMINO20, DNA4
    from .core import encode as enc_mod, bitops
    from .io import fastx
    from .sketch.setsketch import CSetSketch
    from .sketch.shs import _contig_code_batches

    paths = list(args.paths)
    if args.paths_file:
        with open(args.paths_file) as fh:
            paths += [l.strip() for l in fh if l.strip()]
    if not paths:
        print("no input files", file=sys.stderr)
        return 1
    k = args.k
    canon = not args.no_canon
    cyclic = args.cyclic or args.protein or k > 32
    lut = AMINO20.lut if args.protein else DNA4.lut
    save_kmers = args.save_kmers or args.save_kmer_counts
    union = CSetSketch(args.sketch_size, save_kmers, args.save_kmer_counts)
    if cyclic:
        from .core.rolling import RollingEncoder

        n_chars = AMINO20.n_classes if args.protein else 4
        renc = RollingEncoder(k, canon=canon and not args.protein,
                              n_chars=n_chars)
    for path in paths:
        s = CSetSketch(args.sketch_size, save_kmers, args.save_kmer_counts)
        for codes in _contig_code_batches(path, lut, overlap=k - 1):
            if codes.size < k:
                continue
            if cyclic:
                vals, invalid = renc.hashes(codes[None, :])
                v = np.asarray(vals)[0][~np.asarray(invalid)[0]]
            else:
                kmers, invalid = enc_mod.pack_kmers(codes[None, :], k)
                kmers = enc_mod.apply_mask(kmers, k, enc_mod.InputType.DNA)
                if canon:
                    kmers = bitops.canonical(kmers, k)
                v = np.asarray(kmers)[0][~np.asarray(invalid)[0]]
            s.update(v)
        card = s.cardinality()
        print(
            f"{path}\t{card:.1f}. Total updates {s.total_updates()}",
            file=sys.stderr,
        )
        base = os.path.basename(path) if args.basename else path
        if not args.no_per_file:
            s.write(f"{base}.{k}.{args.sketch_size}.ss")
        if save_kmers:
            s.ids().tofile(f"{base}.{k}.{args.sketch_size}.u64.kmers")
            if args.save_kmer_counts:
                s.idcounts().tofile(
                    f"{base}.{k}.{args.sketch_size}.u32.kmercounts"
                )
        union.merge(s)
    print(f"union cardinality: {union.cardinality():.1f}", file=sys.stderr)
    union.write(args.out)
    return 0


def _cmd_distmat(args):
    """Worked equivalent of the reference's distance-matrix analysis
    pipeline (/root/reference/python/run_dist.py:1 drives external
    sketchers into flat distance files; distmat2np.py:1 parses them into
    an (n, n) numpy matrix): sketch every input genome at k, compute the
    pairwise matrix in-process, write PREFIX.tsv (labeled), PREFIX.npy
    (the distmat2np output), and PREFIX.labels.txt.

    --metric mash converts Jaccard j to the Mash distance
    -ln(2j/(1+j))/k (the `mash dist` output run_dist.py collects);
    --hll P estimates via HyperLogLog union cardinalities instead of
    exact sets."""
    import os

    import numpy as np

    from .core import hashes
    from .core.spacer import Spacer
    from .db.build import genome_kmer_set
    from .sketch import compare

    sp = Spacer(args.k, args.k)
    canon = not args.no_canon
    sets = [genome_kmer_set(p, sp, canon) for p in args.paths]
    n = len(sets)
    want_j = args.metric in ("jaccard", "mash")
    if args.hll:
        from .sketch.hll import HyperLogLog

        hlls = []
        for s in sets:
            h = HyperLogLog(args.hll)
            h.addh(s)
            hlls.append(h)
        card = np.array([h.report() for h in hlls])
        mat = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            mat[i, i] = 1.0 if want_j else card[i]
            for j in range(i + 1, n):
                u = hlls[i].merge(hlls[j]).report()
                inter = max(card[i] + card[j] - u, 0.0)
                v = {
                    "jaccard": inter / max(u, 1e-12),
                    "mash": inter / max(u, 1e-12),
                    "intersection": inter,
                    "union": u,
                    "containment": inter / max(card[i], 1e-12),
                }[args.metric]
                mat[i, j] = mat[j, i] = v
    else:
        m = "jaccard" if want_j else args.metric
        mat = compare.pairwise_matrix(sets, metric=m)
    if args.metric == "mash":
        with np.errstate(divide="ignore"):
            j = np.clip(mat, 1e-300, 1.0)
            mat = -np.log(2.0 * j / (1.0 + j)) / args.k
        np.fill_diagonal(mat, 0.0)
    labels = [os.path.basename(p) for p in args.paths]
    with open(args.out + ".tsv", "w") as fh:
        fh.write("#genome\t" + "\t".join(labels) + "\n")
        for i, lab in enumerate(labels):
            fh.write(lab + "\t" + "\t".join(f"{v:.8g}" for v in mat[i]) + "\n")
    np.save(args.out + ".npy", mat.astype(np.float32))
    with open(args.out + ".labels.txt", "w") as fh:
        fh.write("\n".join(labels) + "\n")
    print(
        f"wrote {n}x{n} {args.metric} matrix to {args.out}.npy/.tsv",
        file=sys.stderr,
    )
    return 0


def _cmd_cmpshs(args):
    from .sketch import compare, shs as shs_mod

    sets = [shs_mod.read_shs(p) for p in args.paths]
    mat = compare.pairwise_matrix(sets, metric=args.metric)
    out = open(args.out, "w") if args.out else sys.stdout
    out.write("#path\t" + "\t".join(args.paths) + "\n")
    for i, p in enumerate(args.paths):
        out.write(p + "\t" + "\t".join(f"{v:.8g}" for v in mat[i]) + "\n")
    if args.out:
        out.close()
    return 0


def _cmd_css2ss(args):
    from .sketch.setsketch import CSetSketch

    cs = CSetSketch.read(args.inp)
    b, a = cs.optimal_parameters(qmax=(1 << args.bits) - 1)
    cs.to_packed(b, a, args.bits).write(args.out)
    print(f"packed {cs.m} registers (a={a:.6g} b={b:.6g})", file=sys.stderr)
    return 0


def _cmd_shs2sketch(args):
    from .sketch.setsketch import CSetSketch
    from .sketch.shs import read_shs

    hashes = read_shs(args.inp)
    cs = CSetSketch(args.sketch_size)
    cs.update(hashes)
    b, a = cs.optimal_parameters(qmax=(1 << args.bits) - 1)
    cs.to_packed(b, a, args.bits).write(args.out)
    return 0


def _load_packed_sketches(paths, bits=16, ab=None):
    """Load .ss files; continuous sketches are packed with GLOBAL (a, b)
    so register values stay comparable across samples (required for LSH
    grouping).  Returns (sketches, (b, a) or None)."""
    from .sketch.setsketch import CSetSketch, SetSketch

    loaded = []
    for p in paths:
        try:
            loaded.append(SetSketch.read(p))
        except ValueError:
            loaded.append(CSetSketch.read(p))
    cont = [s for s in loaded if isinstance(s, CSetSketch)]
    if not cont:
        return loaded, None
    if ab is not None:
        b, a = ab
    else:
        maxv = max(s.max() for s in cont)
        minv = min(s.min() for s in cont if s.min() > 0)
        b, a = cont[0].optimal_parameters(maxv, minv, (1 << bits) - 1)
    out = [
        s.to_packed(b, a, bits) if isinstance(s, CSetSketch) else s
        for s in loaded
    ]
    return out, (b, a)


def _cmd_ssi_build(args):
    from .sketch.ssi import SetSketchIndex

    sketches, packed = _load_packed_sketches(args.sketches)
    if packed:
        import json

        print(
            f"packed continuous inputs with global a={packed[1]:.6g} "
            f"b={packed[0]:.6g}",
            file=sys.stderr,
        )
        with open(args.out + ".params", "w") as fh:
            json.dump({"b": packed[0], "a": packed[1], "bits": 16}, fh)
    idx = SetSketchIndex(k=args.k, regs_per_hash=args.regs_per_hash)
    for s in sketches:
        idx.add(s.registers)
    idx.write(args.out)
    print(
        f"indexed {idx.n_samples} sketches, {len(idx.map)} keys", file=sys.stderr
    )
    return 0


def _cmd_ssi_screen(args):
    from .sketch.ssi import SetSketchIndex

    import json
    import os

    idx = SetSketchIndex.read(args.index, regs_per_hash=args.regs_per_hash)
    ab = None
    if os.path.exists(args.index + ".params"):
        with open(args.index + ".params") as fh:
            d = json.load(fh)
        ab = (d["b"], d["a"])
    sketches, _ = _load_packed_sketches(args.queries, ab=ab)
    for p, s in zip(args.queries, sketches):
        hits = idx.topk(s.registers, args.topn)
        row = "\t".join(f"{sid}:{c}" for sid, c in hits)
        print(f"{p}\t{row}")
    return 0


def _cmd_genome2multiset(args):
    from .sketch import shs as shs_mod

    prefix = args.out_prefix or args.path
    written = shs_mod.dump_maps(
        prefix, [args.k], args.path, canon=args.canon,
        flag=shs_mod.WRITE_KVMAP,
    )
    print("\n".join(written), file=sys.stderr)
    return 0


def _cmd_fahist(args):
    from collections import Counter as PyCounter

    from .io import fastx

    out = open(args.out, "w") if args.out else sys.stdout
    for path in args.paths:
        hist = PyCounter()
        for _, seq, _ in fastx.read_fastx(path):
            hist[len(seq)] += 1
        out.write(f"#{path}\n")
        for length in sorted(hist):
            out.write(f"{length}\t{hist[length]}\n")
    if args.out:
        out.close()
    return 0


def _cmd_kmeridx(args):
    from .db.kmeridx import KmerIdx

    idx = KmerIdx(args.k, args.path)
    idx.write(args.out)
    print(f"indexed {len(idx)} distinct {args.k}-mers", file=sys.stderr)
    return 0


def _cmd_stdin2ss(args):
    """stdin2ss (bin/stdin2ss.cpp): reads 16-byte records, sketches the
    first u64 of each into a b-bit packed SetSketch."""
    from .sketch.setsketch import CSetSketch

    fh = open(args.inp, "rb") if args.inp else sys.stdin.buffer
    try:
        raw = fh.read()
    finally:
        if args.inp:
            fh.close()
    vals = np.frombuffer(raw[: len(raw) // 16 * 16], dtype=np.uint64)[0::2]
    cs = CSetSketch(args.sketch_size)
    cs.update(vals)
    bits = 16 if args.use_short else 8
    if args.a > 0 and args.b > 0:
        b, a = args.b, args.a
    else:
        b, a = cs.optimal_parameters(qmax=(1 << bits) - 1)
    packed = cs.to_packed(b, a, bits)
    out = args.out or "/dev/stdout"
    packed.write(out)
    print(f"processed {vals.size} total", file=sys.stderr)
    return 0


def _cmd_setsketchroller(args):
    """setsketchroller (bin/setsketchroller.cpp): inverted kmer -> sample
    index over the .u64.kmers dumps that `setsketch -S` emits."""
    import os

    from .sketch.ssi import SetSketchIndex

    paths = list(args.kmer_files)
    if args.paths_file:
        with open(args.paths_file) as fh:
            paths += [l.strip() for l in fh if l.strip()]
    if not paths:
        print("no input .kmers files", file=sys.stderr)
        return 1
    idx = SetSketchIndex(k=args.k)
    idx.map = {}
    for sid, p in enumerate(paths):
        kmers = np.fromfile(p, dtype=np.uint64)
        for km in np.unique(kmers):
            idx.map.setdefault(int(km), []).append(sid)
        idx.n_samples = sid + 1
    out = args.out or "/dev/stdout"
    idx.write(out)
    names = [os.path.basename(p) if args.trim_folder else p for p in paths]
    for sid, n in enumerate(names):
        print(f"{sid}\t{n}", file=sys.stderr)
    return 0


def _cmd_errexp(args):
    """errexp (bin/errexp.cpp): empirical jaccard-estimation error of HLL
    vs CSetSketch across set sizes and sketch sizes."""
    from .sketch.hll import HyperLogLog
    from .sketch.setsketch import CSetSketch

    rng = np.random.default_rng(0)
    set_sizes = [1 << int(x) for x in args.set_sizes.split(",")]
    sketch_p = [int(x) for x in args.sketch_sizes.split(",")]
    jaccards = np.arange(args.linspace, 1.0, args.linspace)
    print("#setsize\tsketch\tm\ttrue_j\thll_j\tcss_j")
    for n in set_sizes:
        base = rng.integers(0, 1 << 62, 2 * n, dtype=np.uint64)
        for j in jaccards:
            # two sets with expected jaccard j: share s elems of n each
            s = int(round(2 * j / (1 + j) * n))
            a = base[:n]
            b = np.concatenate([base[: s], base[n : 2 * n - s]])
            for p in sketch_p:
                h1 = HyperLogLog(p)
                h1.addh(a)
                h2 = HyperLogLog(p)
                h2.addh(b)
                c1 = CSetSketch(1 << p)
                c1.update(a)
                c2 = CSetSketch(1 << p)
                c2.update(b)
                print(
                    f"{n}\thll/css\t{1 << p}\t{j:.3f}\t"
                    f"{h1.jaccard(h2):.4f}\t{c1.jaccard(c2):.4f}"
                )
    return 0


def _cmd_metatree(args):
    """metatree_main (bin/bonsai.cpp:410-518): group genomes' taxa by
    parent, score shared-kmer bit patterns per parent group, emit the best
    candidate new taxonomy nodes."""
    from .core.spacer import Spacer
    from .metatree.flextree import FMEmitter
    from .metatree.tx import _taxid_of_path
    from .taxonomy.ncbi import parse_nameid_map
    from .taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(args.tax_path)
    name_map = parse_nameid_map(args.nameidmap)
    paths = _paths(args)
    sp = Spacer(args.k, args.k)

    # filter genomes by accepted LCAs (accepted_pass, bin/bonsai.cpp:404)
    tax_to_paths = {}
    for p in paths:
        tid = _taxid_of_path(p, name_map)
        if tid is None:
            continue
        if args.accept_lca and not any(
            tree.lca(l, tid) == l for l in args.accept_lca
        ):
            continue
        tax_to_paths.setdefault(tid, []).append(p)
    if not tax_to_paths:
        print("no genomes mapped to taxa", file=sys.stderr)
        return 1

    # tax2desc map: each taxon also sees its descendants' genomes
    # (tax2desc_genome_map, util.h:1023)
    desc_map = {t: list(ps) for t, ps in tax_to_paths.items()}
    for t, ps in tax_to_paths.items():
        tid = t
        while True:
            parent = tree.parent_map.get(tid, 0)
            if parent == 0:
                break
            desc_map.setdefault(parent, []).extend(ps)
            tid = parent

    fme = FMEmitter(
        tree, desc_map, canonicalize=not args.no_canon, to_add=args.nelem
    )
    # group leaf taxa by parent, one subtree per parent group
    groups = {}
    for t in tax_to_paths:
        groups.setdefault(tree.parent_map.get(t, 0), []).append(t)
    for parent, taxes in sorted(groups.items()):
        fme.process_subtree(parent, sorted(taxes), sp)
    maxtax = max(tree.parent_map)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        emitted = fme.run_collapse(maxtax, out)
    finally:
        if args.out:
            out.close()
    print(f"emitted {len(emitted)} candidate nodes", file=sys.stderr)
    return 0


def _cmd_rolling_multk(args):
    from .sketch.shs import MultiKCounter

    ks = [int(x) for x in args.ks.split(",")]
    for path in args.paths:
        ctr = MultiKCounter(ks, canon=args.canon)
        ctr.add_file(path)
        for k, s in zip(ks, ctr.sets()):
            print(f"{path}\tk={k}\t{s.size}")
    return 0


def _cmd_rolling_multk_sketch(args):
    """rolling_multk_sketch (bin/rolling_multk_sketch.cpp): one rolling
    pass per file, a CSetSketch per k."""
    from .sketch.setsketch import CSetSketch
    from .sketch.shs import MultiKCounter

    ks = [int(x) for x in args.ks.split(",")]
    for path in args.paths:
        ctr = MultiKCounter(ks, canon=args.canon)
        ctr.add_file(path)
        for k, hashes_sorted in zip(ks, ctr.sets()):
            cs = CSetSketch(args.sketch_size)
            cs.update(hashes_sorted)
            print(f"{path}\tk={k}\tcard~{cs.cardinality():.1f}")
            if args.out_prefix:
                cs.write(f"{args.out_prefix}.{k}.css")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
