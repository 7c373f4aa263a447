#!/usr/bin/env python3
"""Generate golden parity artifacts from the reference oracle binary.

Runs the compiled reference `bonsai` (tools/refbuild/build/bonsai — built
from upstream sources with clean-room stubs + documented runnability
patches, see tools/refbuild/README.md) over small committed fixtures and
records, per configuration:

* the DB *content digest* (sha256 over sorted little-endian key/value
  arrays — layout-independent, so any correct builder matches), and
* byte-exact classification outputs (gzipped).

tests/test_golden_oracle.py replays every configuration through bonsai_tpu
and asserts digest + byte equality WITHOUT needing the oracle binary or a
C++ toolchain at test time.

Scale: the default golden set uses phiX + a deterministic 1%-mutated phiX
variant + test/small_genome.fa (seconds per config).  `--full` adds the
5-genome ec corpus (the round-2 interactive verification ran it; it is too
slow for every pytest invocation).

Usage:  python tools/golden_gen.py [--full]
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import random
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DATA = os.path.join(REPO, "tests", "data")
GOLD = os.path.join(DATA, "golden")
ORACLE = os.path.join(REPO, "tools", "refbuild", "build", "bonsai")

NODES = (
    "1\t|\t1\t|\tno rank\t|\n"
    "131567\t|\t1\t|\tno rank\t|\n"
    "2\t|\t131567\t|\tsuperkingdom\t|\n"
    "10239\t|\t131567\t|\tsuperkingdom\t|\n"
    "100\t|\t10239\t|\tspecies\t|\n"
    "101\t|\t100\t|\tstrain\t|\n"
    "102\t|\t100\t|\tstrain\t|\n"
    "200\t|\t2\t|\tspecies\t|\n"
)

# (name, build flags, needs_phase1: None | "t" | "f")
CONFIGS = [
    ("lex_k25", ["-k", "25"], None),
    ("lex_k31_w40", ["-k", "31", "-w", "40"], None),
    ("lex_k25_nocanon", ["-k", "25", "-C"], None),
    ("ent_k25_w37", ["-k", "25", "-w", "37", "-e"], None),
    ("spaced_k21", ["-k", "21", "-S", "0x16,1x4"], None),
    ("min_td_k25_w37", ["-k", "25", "-w", "37"], "t"),
    ("min_fc_k25_w37", ["-k", "25", "-w", "37"], "f"),
]


def mutate(seq: str, rate: float, rng: random.Random) -> str:
    out = list(seq)
    for i in range(len(out)):
        if rng.random() < rate:
            out[i] = rng.choice([b for b in "ACGT" if b != out[i]])
    return "".join(out)


def read_fasta_body(path: str) -> str:
    op = gzip.open if path.endswith(".gz") else open
    return "".join(
        l.strip() for l in op(path, "rt") if not l.startswith(">")
    )


def write_fixtures() -> dict:
    os.makedirs(GOLD, exist_ok=True)
    rng = random.Random(20260818)
    phix = read_fasta_body(os.path.join(DATA, "phix.fa")).upper()
    rand = "".join(rng.choice("ACGT") for _ in range(20000))
    genomes = {
        "g_phix.fa": (">phix_g\n%s\n" % phix, 101),
        "g_phixmut.fa": (">phixmut_g\n%s\n" % mutate(phix, 0.01, rng), 102),
        "g_rand.fa": (">rand_g\n%s\n" % rand, 200),
    }
    paths = []
    nameid = []
    for fn, (text, taxid) in genomes.items():
        p = os.path.join(GOLD, fn)
        with open(p, "w") as fh:
            fh.write(text)
        paths.append(p)
        nameid.append(f"{text[1:].split()[0]}\t{taxid}")
    with open(os.path.join(GOLD, "nodes.dmp"), "w") as fh:
        fh.write(NODES)
    with open(os.path.join(GOLD, "nameidmap.txt"), "w") as fh:
        fh.write("\n".join(nameid) + "\n")

    # mixed single-end reads: both genomes, revcomp, Ns, short reads,
    # lowercase, pure-N
    comp = str.maketrans("ACGTacgtN", "TGCAtgcaN")
    srcs = [phix, genomes["g_phixmut.fa"][0].split("\n")[1], rand]
    lines = []
    for i in range(400):
        s = srcs[rng.randrange(len(srcs))]
        L = rng.choice([90, 90, 120, 60])
        p = rng.randrange(len(s) - L)
        r = s[p : p + L]
        if rng.random() < 0.3:
            r = r.translate(comp)[::-1]
        if rng.random() < 0.15:
            r = list(r)
            for _ in range(rng.randrange(1, 5)):
                r[rng.randrange(L)] = "N"
            r = "".join(r)
        if rng.random() < 0.05:
            r = r[: rng.randrange(8, 24)]
        lines.append(f">r{i}\n{r}\n")
    lines.append(">allN\n" + "N" * 70 + "\n")
    lines.append(">lower\n" + "acgt" * 20 + "\n")
    with open(os.path.join(GOLD, "reads.fa"), "w") as fh:
        fh.write("".join(lines))

    # paired-end mates (names carry /1 + /2 to exercise trim_readno)
    m1, m2 = [], []
    for i in range(120):
        s = srcs[rng.randrange(len(srcs))]
        p = rng.randrange(len(s) - 320)
        m1.append(f">p{i}/1\n{s[p:p+90]}\n")
        m2.append(f">p{i}/2\n{s[p+230:p+320].translate(comp)[::-1]}\n")
    with open(os.path.join(GOLD, "mate1.fa"), "w") as fh:
        fh.write("".join(m1))
    with open(os.path.join(GOLD, "mate2.fa"), "w") as fh:
        fh.write("".join(m2))
    return {"paths": paths}


def db_digest(path: str) -> str:
    from bonsai_tpu.db import formats

    db = formats.load_database(path)
    h = hashlib.sha256()
    h.update(db.table.keys_sorted.astype("<u8").tobytes())
    h.update(db.table.vals_sorted.astype("<u8").tobytes())
    return h.hexdigest()


def run(cmd, **kw):
    r = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if r.returncode != 0:
        sys.stderr.write(f"FAILED: {' '.join(cmd)}\n{r.stderr[-2000:]}\n")
        sys.exit(1)
    return r


EC_NODES = (
    "1\t|\t1\t|\tno rank\t|\n"
    "2\t|\t1\t|\tgenus\t|\n"
    "11\t|\t2\t|\tstrain\t|\n"
    "12\t|\t2\t|\tstrain\t|\n"
    "13\t|\t2\t|\tstrain\t|\n"
    "14\t|\t2\t|\tstrain\t|\n"
    "15\t|\t2\t|\tstrain\t|\n"
)


def write_ec_k12_reads(path: str, n_reads: int = 10003,
                       read_len: int = 101) -> None:
    """Deterministic regeneration of a `test/ec.k12.fa`-style read set
    (the reference's copy is a missing large blob,
    /root/reference/.MISSING_LARGE_BLOBS:1): reads sampled from the
    in-repo K-12 genome with light mutations and occasional Ns, every
    read's truth taxid = 11 (genus ancestor = 2)."""
    import numpy as np

    k12 = os.path.join(DATA, "ec", "GCF_000005845.2_ASM584v2_genomic.fna.gz")
    seq = read_fasta_body(k12).upper().encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    rng = np.random.default_rng(20260819)
    bases = np.array(list(b"ACGT"), dtype=np.uint8)
    lines = []
    for i in range(n_reads):
        p = int(rng.integers(0, len(arr) - read_len))
        r = arr[p : p + read_len].copy()
        # ~0.5%/base substitutions, ~3% of reads carry one N
        mut = rng.random(read_len) < 0.005
        r[mut] = bases[rng.integers(0, 4, int(mut.sum()))]
        if rng.random() < 0.03:
            r[int(rng.integers(0, read_len))] = ord("N")
        lines.append(f">ec.k12.{i}.{p}\n{r.tobytes().decode()}\n")
    with open(path, "wb") as raw:
        with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as z:
            z.write("".join(lines).encode())


def taxid_column(classify_output: bytes) -> bytes:
    """name\ttaxid lines from Kraken-format output (cols 2 and 3)."""
    out = []
    for line in classify_output.decode().splitlines():
        f = line.split("\t")
        if len(f) >= 3:
            out.append(f"{f[1]}\t{f[2]}")
    return ("\n".join(out) + "\n").encode()


def gen_kraken(manifest: dict) -> None:
    """Oracle goldens for the flagship accuracy sets: ec k=31 DB content
    digest + byte digests and per-read taxid columns of the oracle's
    classification of HiSeq/MiSeq (10003 reads each,
    /root/reference/kraken_benchmarks/) and the regenerated ec.k12 read
    set — the round-2 'byte-identical on the full sets' claim becomes a
    committed regression, and taxid agreement % becomes computable
    offline."""
    kb = os.path.join(DATA, "kraken_benchmarks")
    ecdir = os.path.join(DATA, "ec")
    genomes = sorted(
        os.path.join(ecdir, f) for f in os.listdir(ecdir)
        if f.endswith(".fna.gz")
    )
    nodes = os.path.join(GOLD, "ec_nodes.dmp")
    with open(nodes, "w") as fh:
        fh.write(EC_NODES)
    nameid = os.path.join(GOLD, "ec_nameidmap.txt")
    with open(nameid, "w") as fh:
        for gi, g in enumerate(genomes):
            op = gzip.open if g.endswith(".gz") else open
            with op(g, "rt") as gfh:
                acc = gfh.readline()[1:].split()[0]
            fh.write(f"{acc}\t{11 + gi}\n")
    eck12 = os.path.join(GOLD, "ec_k12_reads.fa.gz")
    if not os.path.exists(eck12):
        write_ec_k12_reads(eck12)
    tmp = os.path.join(GOLD, "_ktmp")
    os.makedirs(tmp, exist_ok=True)
    dbp = os.path.join(tmp, "ec_k31.db")
    run([ORACLE, "build", "-k", "31", "-p", "2", "-T", nodes, "-M", nameid,
         dbp, "IGNORED", *genomes])
    entry = {
        "db_digest": db_digest(dbp),
        "k": 31,
        "nodes": "ec_nodes.dmp",
        "nameid": "ec_nameidmap.txt",
        "genomes": [os.path.basename(g) for g in genomes],
        "sets": {},
    }
    print("ec_k31 db", entry["db_digest"][:16])
    sets = {
        "HiSeq": os.path.join(kb, "HiSeq_accuracy.fa"),
        "MiSeq": os.path.join(kb, "MiSeq_accuracy.fa"),
        "ec_k12": eck12,
    }
    for name, reads in sets.items():
        if reads.endswith(".gz"):
            # the oracle reads gz transparently
            pass
        out = os.path.join(tmp, f"{name}.tsv")
        run([ORACLE, "classify", "-p", "2", "-a", "-o", out, dbp, nodes,
             reads])
        with open(out, "rb") as fh:
            data = fh.read()
        sha = hashlib.sha256(data).hexdigest()
        col = taxid_column(data)
        colfn = f"{name}_taxids.tsv.gz"
        with open(os.path.join(GOLD, colfn), "wb") as raw:
            with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as z:
                z.write(col)
        entry["sets"][name] = {
            "reads": os.path.relpath(reads, DATA),
            "sha256": sha,
            "taxids": colfn,
            "n_lines": data.count(b"\n"),
        }
        print(f"{name}: sha256={sha[:16]} ({data.count(b'\n')} lines)")
    manifest["kraken"] = entry
    import shutil

    shutil.rmtree(tmp)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="also run the ec corpus")
    ap.add_argument("--kraken", action="store_true",
                    help="only (re)generate the HiSeq/MiSeq/ec.k12 goldens "
                    "into the existing manifest")
    args = ap.parse_args()
    if not os.path.exists(ORACLE):
        run(["make", "-C", os.path.join(REPO, "tools", "refbuild")])
    if args.kraken:
        mf_path = os.path.join(GOLD, "manifest.json")
        with open(mf_path) as fh:
            manifest = json.load(fh)
        gen_kraken(manifest)
        with open(mf_path, "w") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
        print("kraken goldens written to", GOLD)
        return 0
    fx = write_fixtures()
    nodes = os.path.join(GOLD, "nodes.dmp")
    nameid = os.path.join(GOLD, "nameidmap.txt")
    manifest = {"configs": [], "note": "generated by tools/golden_gen.py"}

    tmp = os.path.join(GOLD, "_tmp")
    os.makedirs(tmp, exist_ok=True)
    for name, flags, phase1 in CONFIGS:
        dbp = os.path.join(tmp, f"{name}.db")
        entry = {"name": name, "flags": flags, "phase1": phase1}
        if phase1 is None:
            run([ORACLE, "build", *flags, "-p", "2", "-T", nodes, "-M", nameid,
                 dbp, "IGNORED", *fx["paths"]])
        else:
            p1 = os.path.join(tmp, f"{name}.p1.db")
            kflags = [flags[i] for i in range(len(flags)) if flags[i - 1] == "-k" or flags[i] == "-k"]
            run([ORACLE, "prebuild", f"-{phase1}", *kflags, "-p", "2",
                 nameid, nodes, p1, *fx["paths"]])
            entry["phase1_digest"] = db_digest(p1)
            run([ORACLE, "build", f"-{phase1}", *flags, "-p", "2", "-T", nodes,
                 "-M", nameid, p1, dbp, *fx["paths"]])
        entry["db_digest"] = db_digest(dbp)
        manifest["configs"].append(entry)
        print(name, entry["db_digest"][:16])

    # classification goldens against the lex_k25 DB
    dbp = os.path.join(tmp, "lex_k25.db")
    outs = {
        "classify_se.tsv.gz": ["-a", os.path.join(GOLD, "reads.fa")],
        "classify_se_noall.tsv.gz": [os.path.join(GOLD, "reads.fa")],
        "classify_pe.tsv.gz": ["-a", os.path.join(GOLD, "mate1.fa"),
                                os.path.join(GOLD, "mate2.fa")],
        "classify_fastq.txt.gz": ["-a", "-f", "-k", os.path.join(GOLD, "reads.fa")],
        "classify_nocanon.tsv.gz": ["-a", "-C", os.path.join(GOLD, "reads.fa")],
    }
    for gz, extra in outs.items():
        out = os.path.join(tmp, "out.tsv")
        run([ORACLE, "classify", "-p", "2", "-o", out,
             *[a for a in extra if a.startswith("-")],
             dbp, nodes, *[a for a in extra if not a.startswith("-")]])
        with open(out, "rb") as fh:
            data = fh.read()
        with open(os.path.join(GOLD, gz), "wb") as raw:
            with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as z:
                z.write(data)
        print(gz, "written")
    manifest["classify"] = {
        "db": "lex_k25",
        "outputs": {k: v for k, v in outs.items()},
    }
    with open(os.path.join(GOLD, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    import shutil

    shutil.rmtree(tmp)
    print("golden artifacts written to", GOLD)
    return 0


if __name__ == "__main__":
    sys.exit(main())
