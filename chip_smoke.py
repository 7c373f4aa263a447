#!/usr/bin/env python
"""Smoke run of bonsai-tpu's main path on a CUDA GPU.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: phase 1 + phase 6 only

Every phase drives the user entry points (``bonsai_tpu.cli.main``: build,
probe-image, classify) in this one process, which holds the card(s), and
checks what comes out against the repo's own references:

1. device   — JAX's platform is "gpu" (anything else fails, never falls
               back to the CPU); nvidia-smi names the card and its power
               limit; the native host library loaded.
2. ec       — the 10.35M-k-mer ec k=31 DB built through `build`, baked
               with `probe-image`; HiSeq, MiSeq and the paired golden
               classified from both the .btpu and the image must equal
               the reference-oracle goldens byte for byte; one
               `classify --trace-dir` run is summarised.
3. compile  — the packed classify step lowered and compiled at the CLI
               batch shape: compile seconds, memory analysis, peak device
               memory, device-step reads/s, output equal to phase 2's.
4. scale    — a seeded synthetic corpus (tools/scale_bench.py gen: 22
               random 5-Mb genomes, ~110M distinct 31-mers) built through
               `build`, 1M seeded reads streamed through `classify`; every
               read must get the taxid its construction gives it.  Then
               the probe-cost vs table-size sweep.
5. device build — `build --device-build` content equals the host build;
               entropy scores on the card equal numpy's.
6. four cards — sharded classify (--db-shards 1/2/4, a2a and psum routes,
               a 4-file sharded DB over 2 ranks) and
               __graft_entry__.dryrun_multichip(4), each byte-identical
               to the one-card output of the same call.

The last stdout line is one JSON object, printed only when every phase
passed; any failure exits non-zero.  Speed readings are smoke readings,
each printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
GOLD = os.path.join(DATA, "golden")
EC_NODES = os.path.join(GOLD, "ec_nodes.dmp")
GOLD_NODES = os.path.join(GOLD, "nodes.dmp")
HISEQ = os.path.join(DATA, "kraken_benchmarks", "HiSeq_accuracy.fa")
CLI_BATCH = 4096  # `classify -c` default
T0 = time.perf_counter()


def log(msg: str) -> None:
    """One stdout line, stamped with seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def cli(*argv) -> None:
    from bonsai_tpu.cli import main

    rc = main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"bonsai_tpu {' '.join(map(str, argv))} -> rc {rc}")


def _manifest() -> dict:
    with open(os.path.join(GOLD, "manifest.json")) as fh:
        return json.load(fh)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for blk in iter(lambda: fh.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def table_digest(path: str) -> str:
    """sha256 over a DB's sorted keys and values (the goldens' digest)."""
    from bonsai_tpu.db.formats import load_database

    t = load_database(path).table
    h = hashlib.sha256()
    h.update(t.keys_sorted.astype("<u8").tobytes())
    h.update(t.vals_sorted.astype("<u8").tobytes())
    return h.hexdigest()


def reading(card: str, name: str, value, unit: str) -> None:
    """One smoke reading per line, with the card it was taken on."""
    log(f"reading {name} = {value} {unit}  [{card}]")


# -- phase 1 ----------------------------------------------------------------
def phase_device(expect_count: int = 1) -> str:
    """Refuse anything but CUDA GPUs; return nvidia-smi's first card
    line."""
    from bonsai_tpu import native
    from bonsai_tpu.device import card_identity, require_gpu

    devs = require_gpu()
    if len(devs) < expect_count:
        raise RuntimeError(f"needs {expect_count} GPUs, JAX sees {len(devs)}")
    card = card_identity()
    if card is None:
        raise RuntimeError("nvidia-smi gave no card name and power limit")
    if native.get_lib() is None:
        raise RuntimeError("native host library did not build or load")
    import jax

    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}, "
        f"jax {jax.__version__}")
    log(f"nvidia-smi: {card}")
    return card.splitlines()[0]


# -- phase 2 ----------------------------------------------------------------
def ec_genomes() -> list:
    return [os.path.join(DATA, "ec", g)
            for g in _manifest()["kraken"]["genomes"]]


def build_ec(work: str) -> str:
    """The ec k=31 DB through `build`; content must equal the oracle's."""
    kk = _manifest()["kraken"]
    db = os.path.join(work, "ec.btpu")
    cli("build", db, *ec_genomes(), "-k", kk["k"], "-T", EC_NODES,
        "-M", os.path.join(GOLD, kk["nameid"]))
    if table_digest(db) != kk["db_digest"]:
        raise AssertionError("ec DB content diverges from the oracle's")
    return db


def build_lex25(work: str) -> str:
    """The paired golden's DB (lex_k25 over the golden genomes)."""
    m = _manifest()
    cfg = next(c for c in m["configs"] if c["name"] == m["classify"]["db"])
    db = os.path.join(work, "lex25.btpu")
    genomes = [os.path.join(GOLD, g)
               for g in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]
    cli("build", db, *genomes, *cfg["flags"], "-T", GOLD_NODES,
        "-M", os.path.join(GOLD, "nameidmap.txt"))
    if table_digest(db) != cfg["db_digest"]:
        raise AssertionError("lex_k25 DB content diverges from the oracle's")
    return db


def classify_accuracy_set(db: str, which: str, out: str, *extra) -> float:
    """Classify HiSeq/MiSeq (-a) from a DB or image; output must hash to
    the oracle golden.  Returns wall seconds of the CLI call."""
    s = _manifest()["kraken"]["sets"][which]
    t0 = time.perf_counter()
    cli("classify", db, EC_NODES, os.path.join(DATA, s["reads"]), "-a",
        "-o", out, *extra)
    dt = time.perf_counter() - t0
    if _sha256(out) != s["sha256"]:
        raise AssertionError(f"{which} from {db}: output diverges from oracle")
    return dt


def classify_against_golden(db: str, gz: str, out: str, *extra) -> None:
    """Classify with the arguments the oracle golden `gz` was made with
    (small lex_k25 goldens); output must equal it byte for byte."""
    args = _manifest()["classify"]["outputs"][gz]
    reads = [os.path.join(GOLD, os.path.basename(a))
             for a in args if not a.startswith("-")]
    flags = [a for a in args if a.startswith("-")]
    cli("classify", db, GOLD_NODES, *reads, *flags, "-o", out, *extra)
    with gzip.open(os.path.join(GOLD, gz), "rb") as fh:
        want = fh.read()
    with open(out, "rb") as fh:
        if fh.read() != want:
            raise AssertionError(f"{gz} from {db}: output diverges")


def summarize_trace(trace_dir: str, plane_prefix: str = "/device:") -> list:
    """[(plane name, line names, [(op name, total ns), ...top 5])] for each
    plane of the newest trace under trace_dir whose name starts with
    plane_prefix; ops are summed by name over the plane's lines."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    ), key=os.path.getmtime)
    if not paths:
        raise AssertionError(f"no trace written under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    planes = []
    for pl in pd.planes:
        if not pl.name.startswith(plane_prefix):
            continue
        totals: dict = {}
        lines = []
        for ln in pl.lines:
            lines.append(ln.name)
            for ev in ln.events:
                totals[ev.name] = totals.get(ev.name, 0.0) + ev.duration_ns
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:5]
        planes.append((pl.name, lines, ops))
    return planes


def phase_ec(work: str, card: str) -> dict:
    t0 = time.perf_counter()
    db = build_ec(work)
    reading(card, "ec_build_wall_s", time.perf_counter() - t0, "s")
    img = os.path.join(work, "ec.image")
    cli("probe-image", db, EC_NODES, img)
    walls = {}
    for tag, src in (("btpu", db), ("image", img)):
        for which in ("HiSeq", "MiSeq"):
            out = os.path.join(work, f"{which}.{tag}.tsv")
            walls[(which, tag)] = classify_accuracy_set(src, which, out)
            log(f"ec: {which} from {tag} == oracle golden")
    log("ec: paired golden")
    lex = build_lex25(work)
    lex_img = os.path.join(work, "lex25.image")
    cli("probe-image", lex, GOLD_NODES, lex_img)
    for tag, src in (("btpu", lex), ("image", lex_img)):
        classify_against_golden(src, "classify_pe.tsv.gz",
                                os.path.join(work, f"pe.{tag}.tsv"))
        log(f"ec: paired from {tag} == oracle golden")
    n = _manifest()["kraken"]["sets"]["HiSeq"]["n_lines"]
    for (which, tag), dt in walls.items():
        reading(card, f"cli_{which}_{tag}_reads_per_s", n / dt,
                "reads/s (one CLI call, DB load and compile included)")
    tdir = os.path.join(work, "trace")
    log("ec: traced HiSeq classify")
    classify_accuracy_set(db, "HiSeq", os.path.join(work, "HiSeq.traced.tsv"),
                          "--trace-dir", tdir)
    planes = summarize_trace(tdir)
    if not planes:
        raise AssertionError("trace holds no device plane")
    for name, lines, ops in planes:
        log(f"trace plane {name}: lines {lines}")
        for op, ns in ops:
            log(f"  trace op {op}: {ns / 1e6:.3f} ms")
    return dict(db=db, hiseq_out=os.path.join(work, "HiSeq.btpu.tsv"))


# -- phase 3 ----------------------------------------------------------------
def phase_compile(db_path: str, nodes: str, reads: str, ref_out: str,
                  card: str, steps: int = 20,
                  batch_size: int = CLI_BATCH) -> float:
    """Compile the packed step at the CLI batch shape; time it; its
    output for the first batch of `reads` must equal the first lines of
    the CLI's -a output `ref_out`."""
    import jax

    from bonsai_tpu.classify import output as out_mod
    from bonsai_tpu.classify.pipeline import Classifier
    from bonsai_tpu.db.formats import load_database
    from bonsai_tpu.io import fastx
    from bonsai_tpu.taxonomy.tree import TaxTree

    tree = TaxTree.from_nodes_dmp(nodes)
    clf = Classifier(load_database(db_path), tree, emit_all=True)
    batch = next(iter(fastx.batch_reads(reads, clf.lut, batch_size=batch_size)))
    pcodes, naux, lengths, lproc, nmode = clf._prepare_batch(batch)
    fn = clf._make_step_packed(False, clf.max_runs, nmode, lproc)
    args = [pcodes] + ([] if naux is None else [naux]) + [
        lengths, clf._arrays[0], clf._arrays[1]
    ]
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    reading(card, "packed_step_compile_s", time.perf_counter() - t0, "s")
    mem = compiled.memory_analysis()
    log(f"memory_analysis (B={pcodes.shape[0]}, lproc={lproc}, n={nmode}): "
        f"{mem}")
    hlo = compiled.as_text()
    log("optimized HLO op counts: " + ", ".join(
        f"{op} {hlo.count(f' {op}(')}"
        for op in ("gather", "scatter", "while", "sort", "fusion")
    ))
    out = compiled(*args)
    for _ in range(3):
        out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(steps):
        jax.block_until_ready(compiled(*args))
    dt = time.perf_counter() - t0
    n = len(batch.names)
    rps = n * steps / dt
    reading(card, "device_step_reads_per_s", rps,
            f"reads/s ({steps} steps of {n} reads, block_until_ready)")
    stats = jax.devices()[0].memory_stats() or {}
    reading(card, "peak_bytes_in_use", stats.get("peak_bytes_in_use"), "B")
    res = clf._finish_batch(batch, (out[0], out[1], lproc, clf.max_runs))
    text = out_mod.format_batch(res, clf.sp.c, emit_all=True)
    with open(ref_out) as fh:
        want = "".join(fh.readline() for _ in range(n))
    if text != want:
        raise AssertionError("compiled step output != CLI output")
    return rps


# -- phase 4 ----------------------------------------------------------------
def _scale_bench():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import scale_bench

    return scale_bench


def write_scale_taxonomy(paths, work: str):
    """nodes.dmp + name map for a synthetic corpus: genome i is leaf
    10+i under genus 2."""
    nodes = os.path.join(work, "syn_nodes.dmp")
    nameid = os.path.join(work, "syn_nameidmap.txt")
    with open(nodes, "w") as fh:
        fh.write("1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tgenus\t|\n")
        for i in range(len(paths)):
            fh.write(f"{10 + i}\t|\t2\t|\tspecies\t|\n")
    with open(nameid, "w") as fh:
        for i, p in enumerate(paths):
            acc = os.path.basename(p)[:-3] + ".1"
            fh.write(f"{acc}\t{10 + i}\n")
    return nodes, nameid


def make_scale_reads(paths, n_reads: int, out: str, seed: int = 1):
    """Seeded FASTA of n_reads 101-bp reads: 80% of them exact slices
    (either strand) of a random corpus genome, the rest uniform random
    sequence.  Returns the expected taxid of each read (10+genome, or 0)."""
    import numpy as np

    read_len = 101
    rng = np.random.default_rng(seed)
    seqs = []
    for p in paths:
        with open(p, "rb") as fh:
            fh.readline()
            seqs.append(np.frombuffer(fh.read().replace(b"\n", b""), np.uint8))
    offs = np.cumsum([0] + [s.size for s in seqs])
    allseq = np.concatenate(seqs)
    n_hit = int(n_reads * 0.8)
    gi = rng.integers(0, len(seqs), n_hit)
    span = np.array([s.size for s in seqs])[gi] - read_len + 1
    start = offs[gi] + (rng.random(n_hit) * span).astype(np.int64)
    hit = allseq[start[:, None] + np.arange(read_len)]
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    rc = rng.random(n_hit) < 0.5
    hit[rc] = comp[hit[rc, ::-1]]
    rand = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n_reads - n_hit, read_len))
    ]
    reads = np.concatenate([hit, rand])
    want = np.concatenate([10 + gi, np.zeros(n_reads - n_hit, np.int64)])
    order = rng.permutation(n_reads)
    reads, want = reads[order], want[order]
    with open(out, "wb") as fh:
        fh.write(b"".join(
            b">r%d\n%s\n" % (i, r.tobytes()) for i, r in enumerate(reads)
        ))
    return want


def check_scale_output(out: str, want) -> None:
    """Every read's taxid (Kraken column 3, -a output) must equal its
    construction's."""
    import numpy as np

    got = np.full(len(want), -1, np.int64)
    with open(out, "rb") as fh:
        for line in fh:
            f = line.split(b"\t", 3)
            got[int(f[1][1:])] = int(f[2])
    bad = np.nonzero(got != want)[0]
    if bad.size:
        i = int(bad[0])
        raise AssertionError(
            f"{bad.size}/{len(want)} reads disagree with their construction "
            f"(r{i}: got {got[i]}, want {want[i]})"
        )


def phase_scale(work: str, card: str, n_genomes: int = 22, mb: float = 5.0,
                n_reads: int = 1_000_000, probe_sizes=(10, 40, 160),
                seed: int = 12345) -> list:
    sb = _scale_bench()
    sdir = os.path.join(work, "scale")
    t0 = time.perf_counter()
    paths = sb.gen(n_genomes, mb, out_dir=sdir, seed=seed)
    nodes, nameid = write_scale_taxonomy(paths, sdir)
    db = os.path.join(sdir, "syn.btpu")
    t1 = time.perf_counter()
    cli("build", db, *paths, "-k", 31, "-T", nodes, "-M", nameid)
    reading(card, "scale_build_wall_s", time.perf_counter() - t1, "s")
    reads = os.path.join(sdir, "reads.fa")
    want = make_scale_reads(paths, n_reads, reads, seed=seed + 1)
    log(f"scale: corpus + reads made in {time.perf_counter() - t0:.1f}s")
    out = os.path.join(sdir, "reads.tsv")
    t1 = time.perf_counter()
    cli("classify", db, nodes, reads, "-a", "-o", out, "--profile")
    dt = time.perf_counter() - t1
    check_scale_output(out, want)
    log(f"scale: {n_reads} reads == construction "
        f"({int((want > 0).sum())} genome, {int((want == 0).sum())} random)")
    reading(card, "scale_cli_reads_per_s", n_reads / dt,
            "reads/s (one CLI call, DB load and compile included)")
    for f in (db, reads, out, *paths):
        os.unlink(f)
    log(f"scale: probe sweep over {list(probe_sizes)}M keys")
    rows = sb.do_probe(probe_sizes)
    for r in rows:
        reading(card, f"probe_ns_{r['keys_m']}M_keys_{r['table_mb']}MB",
                r["ns_per_probe"], "ns/probe")
    return rows


# -- phase 5 ----------------------------------------------------------------
def entropy_scores_match(seed: int = 7, rows: int = 512, L: int = 200,
                         k: int = 25) -> int:
    """Windowed entropy scores on the default device vs the numpy path on
    a seeded batch; raises unless identical.  Returns scores compared."""
    import jax
    import numpy as np

    from bonsai_tpu.core import entropy

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (rows, L)).astype(np.int8)
    kmers = rng.integers(0, 1 << 50, (rows, L - k + 1), dtype=np.uint64)

    def score(c, km):
        H = entropy.entropy_value(entropy.window_code_counts(c, k, 4), k)
        return entropy.entropy_scores(km, H, 1e-3)

    want = score(codes, kmers)
    got = np.asarray(jax.jit(score)(codes, kmers))
    if not np.array_equal(got, want):
        raise AssertionError(
            f"entropy scores differ at {int((got != want).sum())} positions"
        )
    return want.size


def phase_device_build(work: str, card: str) -> None:
    """`build --device-build` of the first two ec genomes == the host
    build; entropy scores on the device == numpy's."""
    from bonsai_tpu.db.formats import load_database

    import numpy as np

    genomes = ec_genomes()[:2]
    nameid = os.path.join(GOLD, _manifest()["kraken"]["nameid"])
    tables = {}
    for tag, extra in (("host", ()), ("device", ("--device-build",))):
        db = os.path.join(work, f"devbuild.{tag}.btpu")
        t0 = time.perf_counter()
        cli("build", db, *genomes, "-k", 31, "-T", EC_NODES, "-M", nameid,
            *extra)
        reading(card, f"{len(genomes)}_genome_{tag}_build_wall_s",
                time.perf_counter() - t0, "s")
        tables[tag] = load_database(db).table
    h, d = tables["host"], tables["device"]
    if not (np.array_equal(h.keys_sorted, d.keys_sorted)
            and np.array_equal(h.vals_sorted, d.vals_sorted)):
        raise AssertionError("device build content != host build")
    log(f"device build: {h.n} k-mers == host build")
    log(f"entropy: {entropy_scores_match()} scores == numpy")


# -- phase 6 ----------------------------------------------------------------
def phase_four_cards(work: str, card: str) -> None:
    """Sharded classify on every split and route, byte-identical to the
    one-card output of this same call."""
    import __graft_entry__

    db = build_ec(work)
    ref = os.path.join(work, "HiSeq.one.tsv")
    classify_accuracy_set(db, "HiSeq", ref)
    with open(ref, "rb") as fh:
        want = fh.read()
    lex = build_lex25(work)
    classify_against_golden(lex, "classify_pe.tsv.gz",
                            os.path.join(work, "pe.one.tsv"))
    sharded4 = os.path.join(work, "ec.shards4")
    cli("build", sharded4, *ec_genomes(), "-k", 31, "-T", EC_NODES,
        "-M", os.path.join(GOLD, "ec_nameidmap.txt"), "--shards", 4)
    runs = [
        ("db-shards 1 (dp=4)", db, ["--db-shards", 1]),
        ("db-shards 4 a2a", db, ["--db-shards", 4]),
        ("db-shards 2 a2a", db, ["--db-shards", 2, "--route", "a2a"]),
        ("db-shards 2 psum", db, ["--db-shards", 2, "--route", "psum"]),
        ("4-file DB over db-shards 2", sharded4, ["--db-shards", 2]),
    ]
    for i, (label, src, extra) in enumerate(runs):
        out = os.path.join(work, f"HiSeq.sharded{i}.tsv")
        t0 = time.perf_counter()
        cli("classify", src, EC_NODES, HISEQ, "-a", "-o", out, *extra)
        dt = time.perf_counter() - t0
        with open(out, "rb") as fh:
            if fh.read() != want:
                raise AssertionError(f"{label}: output != one-card output")
        log(f"four cards: HiSeq {label} == one card")
        reading(card, f"cli_hiseq_{label.replace(' ', '_')}_wall_s", dt, "s")
    for shards in (2, 4):
        out = os.path.join(work, f"pe.sharded{shards}.tsv")
        classify_against_golden(lex, "classify_pe.tsv.gz", out,
                                "--db-shards", shards)
        log(f"four cards: paired db-shards {shards} == one card")
    __graft_entry__.dryrun_multichip(4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    phase = "device"
    try:
        sys.path.insert(0, REPO)
        card = phase_device(expect_count=count)
        import jax

        devs = jax.devices()
        with tempfile.TemporaryDirectory(prefix=".smoke_", dir=REPO) as work:
            if args.four_cards:
                phase = "four cards"
                phase_four_cards(work, card)
            else:
                phase = "ec"
                ec = phase_ec(work, card)
                log("phase ec passed")
                phase = "compile"
                phase_compile(ec["db"], EC_NODES, HISEQ, ec["hiseq_out"],
                              card)
                log("phase compile passed")
                phase = "scale"
                phase_scale(work, card)
                log("phase scale passed")
                phase = "device build"
                phase_device_build(work, card)
            log(f"phase {phase} passed")
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        return 1
    from bonsai_tpu.device import card_identity

    print(card_identity() or card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
