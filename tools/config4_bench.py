#!/usr/bin/env python
"""BASELINE config 4: ~50-genome corpus, prebuild -> tax-depth-minimized
build -> 1-host sharded classify (bin/bonsai.cpp:284-349 phase1 +
:267-281 minimized phase2).

The reference's config-4 corpus is a RefSeq bacterial subset; with zero
network egress this synthesizes the same SHAPE offline: the 10 real genomes shipped in-repo (5 E. coli strains,
3 Methanobacterium formicicum assemblies, Haladaptatus sp. W1, phiX174)
plus ~40 synthetic genomes, all attached to a CURATED REAL NCBI subtree
(real taxids/topology for the named organisms — root to strain depth 7-9;
synthetic genomes attach as fabricated species ids under the real genera,
documented below).  Reads are simulated from the corpus with known source
leaves, so the run reports end-to-end accuracy TIERS (exact leaf /
clade-compatible / wrong / unclassified) alongside throughput and the
`hist` DB composition.

Run:  python tools/config4_bench.py [--synthetic 40] [--syn-mb 0.5]
Everything lands under .bench_cache/config4/; one JSON line per stage.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
C4 = os.path.join(REPO, ".bench_cache", "config4")
DATA = os.path.join(REPO, "tests", "data")
K, W = 31, 50

# Curated REAL NCBI subtree: (taxid, parent, rank).  Topology and ids
# match the public NCBI taxonomy for every named node; strain-level ids
# for the two WGS M. formicicum assemblies and the Haladaptatus isolate
# are fabricated (1000xxx) because those assemblies carry no distinct
# strain taxid.  Synthetic genomes get fabricated species ids (2000xxx)
# under the real genera marked below.
REAL_NODES = [
    (1, 1, "no rank"),
    (131567, 1, "no rank"),            # cellular organisms
    (2, 131567, "superkingdom"),       # Bacteria
    (1224, 2, "phylum"),               # Pseudomonadota
    (1236, 1224, "class"),             # Gammaproteobacteria
    (91347, 1236, "order"),            # Enterobacterales
    (543, 91347, "family"),            # Enterobacteriaceae
    (561, 543, "genus"),               # Escherichia
    (562, 561, "species"),             # Escherichia coli
    (511145, 562, "strain"),           # K-12 MG1655
    (199310, 562, "strain"),           # CFT073
    (386585, 562, "strain"),           # O157:H7 Sakai
    (405955, 562, "strain"),           # APEC O1
    (409438, 562, "strain"),           # SE11
    (2157, 131567, "superkingdom"),    # Archaea
    (28890, 2157, "phylum"),           # Euryarchaeota
    (183925, 28890, "class"),          # Methanobacteria
    (2158, 183925, "order"),           # Methanobacteriales
    (2159, 2158, "family"),            # Methanobacteriaceae
    (2160, 2159, "genus"),             # Methanobacterium
    (2162, 2160, "species"),           # M. formicicum
    (1000001, 2162, "strain"),         # DSM 3637 (fabricated strain id)
    (1000002, 2162, "strain"),         # BRM9
    (1000003, 2162, "strain"),         # DSM 1535
    (183963, 28890, "class"),          # Halobacteria
    (2235, 183963, "order"),           # Halobacteriales
    (1963268, 2235, "family"),         # Haladaptataceae
    (367188, 1963268, "genus"),        # Haladaptatus
    (1000004, 367188, "species"),      # Haladaptatus sp. W1 (fabricated)
    (10239, 1, "superkingdom"),        # Viruses
    (10841, 10239, "family"),          # Microviridae
    (10847, 10841, "species"),         # phiX174
]
# synthetic species attach under these real genera (round-robin)
SYN_PARENTS = [561, 2160, 367188]

REAL_GENOMES = [
    # (path, leaf taxid)
    (f"{DATA}/ec/GCF_000005845.2_ASM584v2_genomic.fna.gz", 511145),
    (f"{DATA}/ec/GCF_000007445.1_ASM744v1_genomic.fna.gz", 199310),
    (f"{DATA}/ec/GCF_000008865.1_ASM886v1_genomic.fna.gz", 386585),
    (f"{DATA}/ec/GCF_000009565.1_ASM956v1_genomic.fna.gz", 405955),
    (f"{DATA}/ec/GCF_000010245.2_ASM1024v1_genomic.fna.gz", 409438),
    (f"{DATA}/GCF_000302455.1_ASM30245v1_genomic.fna.gz", 1000001),
    (f"{DATA}/GCF_000762265.1_ASM76226v1_genomic.fna.gz", 1000002),
    (f"{DATA}/GCF_000953115.1_DSM1535_genomic.fna.gz", 1000003),
    (f"{DATA}/GCF_001723155.1_ASM172315v1_genomic.fna.gz", 1000004),
    (f"{DATA}/phix.fa", 10847),
]


def make_corpus(n_syn: int, syn_mb: float):
    """Corpus dir + nodes.dmp + nameidmap; returns (paths_file, nodes,
    nameid, leaf_of_path)."""
    from bonsai_tpu.io import fastx
    from bonsai_tpu.taxonomy.ncbi import accession_from_header

    os.makedirs(C4, exist_ok=True)
    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    nodes = list(REAL_NODES)
    name_rows = []
    leaf_of = {}
    paths = []
    for p, tax in REAL_GENOMES:
        paths.append(p)
        leaf_of[p] = tax
        name_rows.append((accession_from_header(fastx.first_header(p)), tax))
    for i in range(n_syn):
        tax = 2000001 + i
        nodes.append((tax, SYN_PARENTS[i % len(SYN_PARENTS)], "species"))
        p = os.path.join(C4, f"SYNC4_{i:03d}.fa")
        if not os.path.exists(p):
            L = int(syn_mb * 1e6)
            seq = bases[rng.integers(0, 4, L)].tobytes()
            with open(p + ".tmp", "wb") as fh:
                fh.write(f">SYNC4_{i:03d}.1 synthetic species\n".encode())
                for j in range(0, L, 80):
                    fh.write(seq[j : j + 80] + b"\n")
            os.replace(p + ".tmp", p)
        else:
            rng.integers(0, 4, int(syn_mb * 1e6))  # keep the stream aligned
        paths.append(p)
        leaf_of[p] = tax
        name_rows.append((f"SYNC4_{i:03d}.1", tax))
    nd = os.path.join(C4, "nodes.dmp")
    with open(nd, "w") as fh:
        for t, par, rank in nodes:
            fh.write(f"{t}\t|\t{par}\t|\t{rank}\t|\n")
    nm = os.path.join(C4, "nameidmap.txt")
    with open(nm, "w") as fh:
        for acc, tax in name_rows:
            fh.write(f"{acc}\t{tax}\n")
    pf = os.path.join(C4, "paths.txt")
    with open(pf, "w") as fh:
        fh.write("\n".join(paths) + "\n")
    return pf, nd, nm, leaf_of


def simulate_reads(leaf_of, n_per_genome: int, readlen: int = 101,
                   err: float = 0.002):
    """Reads with known source leaves; ~err per-base substitutions."""
    from bonsai_tpu.io import fastx

    rng = np.random.default_rng(99)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rf = os.path.join(C4, "reads.fa")
    truth = {}
    with open(rf + ".tmp", "w") as fh:
        idx = 0
        for p, leaf in leaf_of.items():
            contigs = [
                np.frombuffer(s, np.uint8)
                for _, s, _ in fastx.read_fastx(p)
                if len(s) >= readlen
            ]
            if not contigs:
                continue
            for _ in range(n_per_genome):
                c = contigs[rng.integers(0, len(contigs))]
                s0 = int(rng.integers(0, len(c) - readlen))
                r = c[s0 : s0 + readlen].copy()
                nerr = rng.binomial(readlen, err)
                if nerr:
                    pos = rng.integers(0, readlen, size=nerr)
                    r[pos] = bases[rng.integers(0, 4, size=nerr)]
                name = f"c4r{idx}"
                truth[name] = leaf
                fh.write(f">{name}\n{r.tobytes().decode()}\n")
                idx += 1
    os.replace(rf + ".tmp", rf)
    return rf, truth


def run_cli(args, env=None):
    e = dict(os.environ)
    if env:
        e.update(env)
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "bonsai_tpu", *args], cwd=REPO,
        capture_output=True, text=True, env=e,
    )
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-4000:])
        raise RuntimeError(f"CLI failed: {args[:3]}")
    return time.time() - t0, r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", type=int, default=40)
    ap.add_argument("--syn-mb", type=float, default=0.5)
    ap.add_argument("--reads-per-genome", type=int, default=400)
    ap.add_argument("--db-ranks", type=int, default=4)
    ap.add_argument("--shards", default="4",
                    help="forced shard count for the DB dir (the "
                         "minimized DB is small; config 4 is about the "
                         "SHARDED 1-host layout, not the size policy)")
    ap.add_argument("--platform", default="cpu",
                    help="cpu = virtual mesh (default); cuda = the "
                         "GPUs JAX finds")
    args = ap.parse_args()

    import bonsai_tpu  # noqa: F401

    pf, nodes, nameid, leaf_of = make_corpus(args.synthetic, args.syn_mb)
    print(json.dumps(dict(
        metric="c4_corpus", genomes=len(leaf_of),
        synthetic=args.synthetic,
    )), flush=True)

    env = {"JAX_PLATFORMS": args.platform}
    p1 = os.path.join(C4, "phase1_td.btpu")
    t, _ = run_cli(["prebuild", nameid, nodes, p1, "-k", str(K), "-t",
                    "-F", pf], env)
    print(json.dumps(dict(metric="c4_prebuild", wall_s=round(t, 1))),
          flush=True)

    dbdir = os.path.join(C4, "dbdir")
    t, r = run_cli(["build", dbdir, "-k", str(K), "-w", str(W),
                    "-T", nodes, "-M", nameid, "-F", pf, "-t",
                    "--phase1-db", p1, "--shards", str(args.shards)], env)
    with open(os.path.join(dbdir, "manifest.json")) as fh:
        mf = json.load(fh)
    print(json.dumps(dict(
        metric="c4_build", wall_s=round(t, 1), kmers=mf["n"],
        shards=mf["ndb"], kmers_per_s=round(mf["n"] / t, 1),
    )), flush=True)

    t, r = run_cli(["hist", dbdir], env)
    hist_rows = [l for l in r.stdout.splitlines() if l.strip()][:8]
    print(json.dumps(dict(metric="c4_hist", top=hist_rows)), flush=True)

    rf, truth = simulate_reads(leaf_of, args.reads_per_genome)
    out = os.path.join(C4, "out.tsv")
    ranks = min(args.db_ranks, mf["ndb"])
    t, r = run_cli(
        ["classify", dbdir, nodes, rf, "-a", "-o", out,
         "--db-shards", str(ranks), "-c", "8192"],
        {**env,
         "XLA_FLAGS": f"--xla_force_host_platform_device_count={2*ranks}"},
    )
    n_reads = len(truth)

    # accuracy tiers against the known source leaves
    from bonsai_tpu.taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(nodes)
    exact = clade = wrong = uncls = 0
    with open(out) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 3:
                continue
            want = truth[f[1]]
            got = int(f[2])
            if got == 0:
                uncls += 1
            elif got == want:
                exact += 1
            elif tree.lca(got, want) == got:
                clade += 1  # ancestor of the truth (LCA fold)
            else:
                wrong += 1
    print(json.dumps(dict(
        metric="c4_classify",
        reads=n_reads,
        db_ranks=ranks,
        wall_s=round(t, 1),
        reads_per_s=round(n_reads / t, 1),
        exact_pct=round(100 * exact / n_reads, 2),
        clade_pct=round(100 * clade / n_reads, 2),
        wrong_pct=round(100 * wrong / n_reads, 2),
        unclassified_pct=round(100 * uncls / n_reads, 2),
    )), flush=True)
    assert wrong / n_reads < 0.02, "cross-clade misclassification"


if __name__ == "__main__":
    main()
