#!/usr/bin/env python
"""a2a capacity-factor study: pick the default cf from data instead of a
guess.

The routed probe sends, per round, at most cap = ceil(Q_local/ndb * cf)
queries to each owner; a (source device, owner) bucket with more than cap
pending queries spills to further rounds.  ROUNDS NEEDED is a pure
function of the query stream and the mesh shape:

    rounds = max over (src, owner) of ceil(count[src, owner] / cap)

so it can be computed exactly on the host for real read sets — no mesh
required.  Per-round device work is the owner-side probe of ndb*cap
rows (2 row-gathers each) plus the bucketize sort of Q_local, so each
configuration also reports the probe rows it pays, rounds * ndb * cap;
the default is the smallest cf that needs one round on real data.

Sweeps HiSeq batches (real data) and adversarial skew (all kmers to one
owner) across mesh shapes; prints one JSON line per configuration.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

def rounds_needed(counts: np.ndarray, q_local: int, ndb: int,
                  cf: float) -> int:
    cap = max(int(np.ceil(q_local / ndb * cf)), 1)
    return int(np.ceil(counts.max() / cap)) if counts.size else 1


def probe_rows(q_local: int, ndb: int, cf: float, rounds: int) -> int:
    cap = max(int(np.ceil(q_local / ndb * cf)), 1)
    return rounds * ndb * cap


def hiseq_kmers(batch_rows: int):
    import bonsai_tpu  # noqa: F401
    from bonsai_tpu.core import bitops, encode
    from bonsai_tpu.core.alphabet import DNA4
    from bonsai_tpu.io import fastx

    reads = os.path.join(
        REPO, "tests", "data", "kraken_benchmarks", "HiSeq_accuracy.fa"
    )
    lut = DNA4.lut
    out = []
    for b in fastx.batch_reads(reads, lut, batch_size=batch_rows):
        codes = np.where(b.codes < 0, 0, b.codes)
        km, inv = encode.pack_kmers(codes, 31)
        km = bitops.canonical(km, 31)
        valid = (~inv) & (
            np.arange(km.shape[1]) < (b.lengths - 30)[:, None]
        )
        out.append((km, valid))
    return out


def main():
    from bonsai_tpu.db.table import shard_owner

    results = []
    batches = hiseq_kmers(8192)
    for ndb in (2, 4, 8, 16):
        for dp in (1, 2):
            nranks = ndb * dp
            worst = {}
            for km, valid in batches:
                B = km.shape[0]
                rows_per_rank = -(-B // nranks)
                q_local = rows_per_rank * km.shape[1]
                for r in range(nranks):
                    sl = slice(r * rows_per_rank, (r + 1) * rows_per_rank)
                    kk = km[sl][valid[sl]]
                    own = shard_owner(kk, ndb)
                    counts = np.bincount(own, minlength=ndb)
                    for cf in (1.0, 1.05, 1.1, 1.25, 1.5, 2.0):
                        rr = rounds_needed(counts, q_local, ndb, cf)
                        worst[cf] = max(worst.get(cf, 1), rr)
            row = dict(
                metric="a2a_cf_hiseq", ndb=ndb, dp=dp,
                worst_rounds={str(k): v for k, v in worst.items()},
                probe_rows={
                    str(cf): probe_rows(
                        -(-8192 // nranks) * batches[0][0].shape[1],
                        ndb, cf, r,
                    )
                    for cf, r in worst.items()
                },
            )
            results.append(row)
            print(json.dumps(row), flush=True)
    # adversarial skew: every kmer owned by rank 0 (e.g. poly-A reads)
    for ndb in (4, 8):
        q_local = 8192 // ndb * 71
        counts = np.zeros(ndb, dtype=np.int64)
        counts[0] = q_local  # all to one owner
        row = dict(
            metric="a2a_cf_skew", ndb=ndb,
            rounds={
                str(cf): rounds_needed(counts, q_local, ndb, cf)
                for cf in (1.0, 1.25, 2.0)
            },
        )
        print(json.dumps(row), flush=True)
    # recommendation: smallest cf whose worst-case real-data rounds == 1
    best = None
    for cf in (1.0, 1.05, 1.1, 1.25, 1.5):
        if all(
            r["worst_rounds"][str(cf)] == 1
            for r in results
        ):
            best = cf
            break
    print(json.dumps(dict(metric="a2a_cf_recommendation", cf=best)))


if __name__ == "__main__":
    main()
