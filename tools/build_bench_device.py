#!/usr/bin/env python
"""Measure device vs host DB build on the ec 5-genome corpus.

Runs each build twice in-process: the first device run pays compiles
(one per distinct merge-shape), the second is the steady-state number.
Content equality is asserted against the host build every time.

Usage: python tools/build_bench_device.py [block_log2=22]
"""

import hashlib
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    block = 1 << int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 22
    import jax

    from bonsai_tpu.core.spacer import Spacer
    from bonsai_tpu.db.build import lca_map
    from bonsai_tpu.db.build_device import device_lca_map
    from bonsai_tpu.io import fastx
    from bonsai_tpu.taxonomy.ncbi import accession_from_header
    from bonsai_tpu.taxonomy.tree import TaxTree

    print(f"platform: {jax.devices()[0].platform}  block={block}",
          file=sys.stderr)
    tree = TaxTree({1: 0, 2: 1, 11: 2, 12: 2, 13: 2, 14: 2, 15: 2})
    ecdir = os.path.join(REPO, "tests", "data", "ec")
    genomes = sorted(
        os.path.join(ecdir, f) for f in os.listdir(ecdir)
        if f.endswith(".fna.gz")
    )
    name_map = {}
    for gi, g in enumerate(genomes):
        name_map[accession_from_header(fastx.first_header(g))] = 11 + gi
    sp = Spacer(31, 31)

    t0 = time.time()
    host = lca_map(genomes, tree, name_map, sp)
    t_host = time.time() - t0
    ck_host = hashlib.sha256(
        host.keys_sorted.tobytes()
        + np.asarray(host.vals_sorted, dtype=np.uint64).tobytes()
    ).hexdigest()[:16]
    print(f"host build: {t_host:.1f}s  {host.n} kmers  sha {ck_host}",
          file=sys.stderr)

    for run in (1, 2):
        t0 = time.time()
        dev = device_lca_map(genomes, tree, name_map, sp, block=block)
        t_dev = time.time() - t0
        ck_dev = hashlib.sha256(
            dev.keys_sorted.tobytes()
            + np.asarray(dev.vals_sorted, dtype=np.uint64).tobytes()
        ).hexdigest()[:16]
        ok = "IDENTICAL" if ck_dev == ck_host else "MISMATCH"
        print(
            f"device build run {run}: {t_dev:.1f}s  {dev.n} kmers  "
            f"sha {ck_dev}  [{ok}]",
            file=sys.stderr,
        )
        assert ck_dev == ck_host


if __name__ == "__main__":
    main()
