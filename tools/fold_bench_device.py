#!/usr/bin/env python
"""Isolate the device LCA-fold throughput from host I/O and transfers.

Generates G synthetic sorted-unique kmer runs, then times
  * host fold:   db.build.lca_fold_runs (native k-way C merge)
  * device fold: db.build_device.device_fold_runs (XLA sort-based merge)
on identical inputs, asserting identical content.  The device timing
includes the run uploads and the final result fetch (an upper bound on
the fold alone).

Usage: python tools/fold_bench_device.py [n_per_run=2_000_000] [G=6]
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    G = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    import jax

    from bonsai_tpu.db.build import lca_fold_runs
    from bonsai_tpu.db.build_device import device_fold_runs
    from bonsai_tpu.taxonomy.tree import TaxTree

    print(f"platform: {jax.devices()[0].platform}  n/run={n} G={G}",
          file=sys.stderr)
    tree = TaxTree({1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3, 14: 3})
    rng = np.random.default_rng(0)
    taxa = [11, 12, 13, 14, 11, 12, 13, 14]
    runs = []
    for g in range(G):
        # ~50% overlap across runs: draw from a domain of 4*n
        ks = np.unique(rng.integers(0, 4 * n, size=n, dtype=np.uint64))
        runs.append((ks, taxa[g % len(taxa)]))
    total = sum(len(k) for k, _ in runs)

    t0 = time.time()
    hk, ht = lca_fold_runs(
        np.zeros(0, np.uint64), np.zeros(0, np.uint32), runs, tree
    )
    t_host = time.time() - t0
    print(
        f"host fold:   {t_host:.2f}s  ({total/1e6:.1f}M in -> "
        f"{len(hk)/1e6:.2f}M unique, {total/t_host/1e6:.1f}M elem/s)",
        file=sys.stderr,
    )

    for run in (1, 2):
        t0 = time.time()
        dk, dt = device_fold_runs(runs, tree)
        t_dev = time.time() - t0
        ok = (
            "IDENTICAL"
            if np.array_equal(hk, dk) and np.array_equal(ht, dt)
            else "MISMATCH"
        )
        print(
            f"device fold run {run}: {t_dev:.2f}s "
            f"({total/t_dev/1e6:.1f}M elem/s) [{ok}]",
            file=sys.stderr,
        )
        assert ok == "IDENTICAL"


if __name__ == "__main__":
    main()
