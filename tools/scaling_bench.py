#!/usr/bin/env python
"""Multi-device scaling benchmark for the sharded classifier.

Measures reads/s of ShardedClassifier at increasing mesh widths and
reports scaling efficiency vs 1 device (the BASELINE north-star metric:
>= 85% at 2+ hosts), plus the ANALYTIC per-chip row-gather volume — the
probe's memory traffic, and the scaling model for a gather-bound
workload.  The a2a route's volume is flat in ndb;
the psum route's grows ndb-fold, which is why a2a is the default for
db-sharded meshes.

On a multi-host cluster, run one process per host with jax.distributed
(DIST=1); on a dev box, set
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
for a functional (not performance-meaningful) check.

Env: SHARD_DB=<n> to shard the table over a 'db' axis;
     ROUTE=a2a|psum|auto (default auto).
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

if os.environ.get("DIST"):
    import jax

    jax.distributed.initialize()

import bench as bench_mod  # noqa: E402
import bonsai_tpu  # noqa: F401,E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bonsai_tpu.parallel.mesh import make_mesh  # noqa: E402
from bonsai_tpu.parallel.sharded import ShardedClassifier  # noqa: E402


def _sync(x):
    np.asarray(jnp.ravel(jax.tree_util.tree_leaves(x)[0])[:1])


def run_width(db, tree, n_dev, codes, lengths, db_shards=1, steps=5,
              route="auto"):
    mesh = make_mesh({"dp": n_dev // db_shards, "db": db_shards})
    sc = ShardedClassifier(db, tree, mesh, route=route)
    out = sc.step(codes, lengths)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        # chain: previous miss counts perturb the pad column
        codes2 = codes  # static is fine here: sharded path recomputes
        out = sc.step(codes2, lengths)
    _sync(out)
    dt = (time.perf_counter() - t0) / steps
    return codes.shape[0] / dt, sc


def main():
    db, tree = bench_mod.get_db()
    n = len(jax.devices())
    db_shards = int(os.environ.get("SHARD_DB", 1))
    route = os.environ.get("ROUTE", "auto")
    B = int(os.environ.get("BENCH_BATCH", 8192))
    codes, lengths = bench_mod.make_reads(B)
    L = codes.shape[1]
    widths = [w for w in (1, 2, 4, 8, 16, 32) if w <= n]
    base = None
    results = []
    for w in widths:
        shards = db_shards if w % max(db_shards, 1) == 0 and db_shards <= w else 1
        rps, sc = run_width(db, tree, w, codes, lengths, shards, route=route)
        rows = sc.gather_rows_per_step(B, L)
        if base is None:
            base = rps
        eff = rps / (base * w)
        results.append(dict(devices=w, db_shards=shards, route=sc.route,
                            reads_per_s=round(rps, 1),
                            efficiency=round(eff, 4),
                            gather_rows_per_chip=rows))
        print(
            f"devices={w:3d} db={shards} route={sc.route:4s}  "
            f"{rps:12.1f} reads/s  eff={eff:.2%}  "
            f"gather_rows/chip={rows}",
            file=sys.stderr, flush=True,
        )
    print(json.dumps(results))


if __name__ == "__main__":
    main()
