#!/usr/bin/env python
"""Kraken-benchmark accuracy evaluation.

The reference ships HiSeq/MiSeq accuracy sets with expected Kraken-format
classifications (kraken_benchmarks/{HiSeq,MiSeq}_{accuracy.fa,class.txt},
SURVEY §4 "Integration / accuracy data").  Given a database built over the
same reference genomes, this classifies the read sets and scores per-read
agreement with the expected taxids (exact + genus-level-ancestor match).

Usage:
  python tools/accuracy_eval.py <db.btpu> <nodes.dmp> [--set HiSeq|MiSeq]

(The genomes behind the published class.txt come from RefSeq — fetch with
bonsai_tpu/scripts/download_genomes.py where network is available.)
"""
import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bonsai_tpu  # noqa: F401,E402
import numpy as np  # noqa: E402


def load_expected(path):
    """class.txt lines: C/U <read> <taxid> ..."""
    exp = {}
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) >= 3:
                exp[f[1]] = int(f[2])
    return exp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("db", nargs="?", default=None)
    ap.add_argument("tax_path", nargs="?", default=None)
    ap.add_argument("--set", dest="which", default="HiSeq",
                    choices=["HiSeq", "MiSeq", "ec_k12"])
    ap.add_argument("--offline", action="store_true",
                    help="no-arguments mode: build the in-repo ec k=31 DB "
                    "+ mini taxonomy (tests/data/golden/ec_nodes.dmp) and "
                    "score the regenerated ec.k12 read set against its "
                    "ground truth (every read is from K-12, taxid 11) and "
                    "against the committed oracle taxid column")
    ap.add_argument("--data-dir",
                    default=os.path.join(REPO, "tests", "data",
                                         "kraken_benchmarks"))
    args = ap.parse_args()

    from bonsai_tpu.classify.pipeline import Classifier
    from bonsai_tpu.db.formats import load_database, import_bonsai_database
    from bonsai_tpu.io import fastx
    from bonsai_tpu.taxonomy.tree import TaxTree

    if args.offline:
        import gzip

        gold = os.path.join(REPO, "tests", "data", "golden")
        ecdir = os.path.join(REPO, "tests", "data", "ec")
        from bonsai_tpu.core.spacer import Spacer
        from bonsai_tpu.db.build import lca_map
        from bonsai_tpu.db.formats import Database

        tree = TaxTree.from_nodes_dmp(os.path.join(gold, "ec_nodes.dmp"))
        genomes = sorted(
            os.path.join(ecdir, f) for f in os.listdir(ecdir)
            if f.endswith(".fna.gz")
        )
        table = lca_map(genomes, tree,
                        os.path.join(gold, "ec_nameidmap.txt"),
                        Spacer(31, 31), canonicalize=True)
        db = Database(table=table, k=31, w=31, gaps=[0] * 30)
        clf = Classifier(db, tree)
        reads_fa = os.path.join(gold, "ec_k12_reads.fa.gz")
        with gzip.open(os.path.join(gold, "ec_k12_taxids.tsv.gz"),
                       "rt") as fh:
            oracle = dict((l.split("\t")[0], int(l.split("\t")[1]))
                          for l in fh if l.strip())
        n = o_agree = exact = genus = uncls = 0
        ec_clade = {2, 11, 12, 13, 14, 15}
        for batch in fastx.batch_reads(reads_fa, clf.lut, batch_size=4096):
            res = clf.classify_batch(batch)
            for name, got in zip(batch.names, res.taxon):
                n += 1
                got = int(got)
                o_agree += int(oracle.get(name.decode()) == got)
                exact += int(got == 11)
                genus += int(got in ec_clade)
                uncls += int(got == 0)
        print(f"set=ec_k12 reads={n} (ground truth: K-12, taxid 11)")
        print(f"taxid agreement vs reference oracle: {o_agree/n:.2%}")
        print(f"exact-strain={exact/n:.2%} clade-compatible={genus/n:.2%} "
              f"unclassified={uncls/n:.2%}")
        return 0

    if not args.db or not args.tax_path:
        ap.error("db and tax_path are required without --offline")
    if os.path.isdir(args.db):
        from bonsai_tpu.db.formats import load_database_sharded

        db = load_database_sharded(args.db)
    else:
        try:
            db = load_database(args.db)
        except ValueError:
            db = import_bonsai_database(args.db)
    tree = TaxTree.from_nodes_dmp(args.tax_path)
    clf = Classifier(db, tree)

    reads_fa = os.path.join(args.data_dir, f"{args.which}_accuracy.fa")
    class_txt = os.path.join(args.data_dir, f"{args.which}_class.txt")
    expected = load_expected(class_txt)

    known = set(int(t) for t in tree.parent_map)
    n = exact = anc = wrong = both_unclassified = 0
    ours_unclassified = 0
    for batch in fastx.batch_reads(reads_fa, clf.lut, batch_size=4096):
        res = clf.classify_batch(batch)
        for name, got in zip(batch.names, res.taxon):
            key = name.decode()
            want = expected.get(key)
            if want is None:
                continue
            n += 1
            got = int(got)
            if got == 0:
                ours_unclassified += 1
                if want == 0:
                    both_unclassified += 1
                continue
            if got == want:
                exact += 1
            elif (want != 0 and want in known and got in known
                  and tree.lca(got, want) in (got, want)):
                anc += 1  # one is an ancestor of the other
            else:
                wrong += 1
    # the two headline tiers: exact-taxid and
    # clade-compatible (exact + ancestor) vs the SHIPPED class files.
    # NOTE the reference's number is anchored on a RefSeq DB of the 10
    # mock-community organisms; a DB without them (the zero-egress
    # offline situation) turns this into a NEGATIVE CONTROL — expect
    # ~100% unclassified and read `wrong` as the false-positive count.
    print(f"set={args.which} reads={n} db_taxa={len(known)}")
    print(f"exact={exact} ({exact/max(n,1):.2%})")
    print(
        f"clade-compatible={exact+anc} ({(exact+anc)/max(n,1):.2%})"
    )
    print(f"wrong(false-positive)={wrong} ({wrong/max(n,1):.2%})")
    print(f"unclassified: ours={ours_unclassified} "
          f"({ours_unclassified/max(n,1):.2%}) agreeing={both_unclassified}")
    import json as _json

    print(_json.dumps(dict(
        metric="flagship_groundtruth", set=args.which, reads=n,
        exact_pct=round(100 * exact / max(n, 1), 2),
        clade_compatible_pct=round(100 * (exact + anc) / max(n, 1), 2),
        wrong_pct=round(100 * wrong / max(n, 1), 2),
        unclassified_pct=round(100 * ours_unclassified / max(n, 1), 2),
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
