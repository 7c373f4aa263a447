#!/usr/bin/env python
"""Why does the production probe cost more per query than an isolated row
gather?  Isolate: table size, 2-D vs flat queries, bucket-hash cost."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bonsai_tpu  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np

from bonsai_tpu.core import hashes

NQ = 1 << 21  # ~2.3M queries like the 32k-read step
SALT = jnp.uint64(0xA24BAED4963EE407)


def _sync(x):
    leaf = jax.tree_util.tree_leaves(x)[0]
    np.asarray(jnp.ravel(leaf)[:1])


def timed(fn, *args, n=10):
    out = fn(*args)
    out = fn(*args, salt=out)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, salt=out)
    _sync(out)
    return (time.perf_counter() - t0) / n


def main():
    rng = np.random.default_rng(0)
    part = os.environ.get("PART", "all")
    for nb_log in (21, 22):
        NB = 1 << nb_log
        shift = 64 - nb_log
        rows = jnp.asarray(
            rng.integers(0, 1 << 63, (NB, 8), dtype=np.uint64)
        )
        q = jnp.asarray(rng.integers(0, 1 << 62, NQ, dtype=np.uint64))
        b1n = (np.asarray(hashes.splitmix64(np.asarray(q))) >> shift).astype(np.int32)
        b2n = (
            np.asarray(hashes.splitmix64(np.asarray(q) ^ np.uint64(0xA24BAED4963EE407)))
            >> shift
        ).astype(np.int32)
        b1 = jnp.asarray(b1n)
        b2 = jnp.asarray(b2n)

        @jax.jit
        def pre_idx(b1, b2, q, rows, salt=0):
            s = jnp.ravel(jax.tree_util.tree_leaves(salt)[0])[0].astype(jnp.int32)
            b1 = (b1 + s) % NB
            found = jnp.zeros(q.shape, bool)
            val = jnp.zeros(q.shape, jnp.uint64)
            for b in (b1, b2):
                row = rows[b]
                eq = row[:, :4] == q[:, None]
                hit = jnp.any(eq, -1)
                v = jnp.sum(jnp.where(eq, row[:, 4:], 0), -1)
                val = jnp.where(hit & ~found, v, val)
                found |= hit
            return val, found

        @jax.jit
        def hash_idx(q, rows, salt=0):
            s = jnp.ravel(jax.tree_util.tree_leaves(salt)[0])[0].astype(jnp.uint64)
            qq = q + s
            h1 = hashes.splitmix64(qq)
            h2 = hashes.splitmix64(qq ^ SALT)
            b1 = (h1 >> jnp.uint64(shift)).astype(jnp.int32)
            b2 = (h2 >> jnp.uint64(shift)).astype(jnp.int32)
            found = jnp.zeros(q.shape, bool)
            val = jnp.zeros(q.shape, jnp.uint64)
            for b in (b1, b2):
                row = rows[b]
                eq = row[:, :4] == q[:, None]
                hit = jnp.any(eq, -1)
                v = jnp.sum(jnp.where(eq, row[:, 4:], 0), -1)
                val = jnp.where(hit & ~found, v, val)
                found |= hit
            return val, found

        @jax.jit
        def hash_only(q, rows, salt=0):
            s = jnp.ravel(jax.tree_util.tree_leaves(salt)[0])[0].astype(jnp.uint64)
            qq = q + s
            h1 = hashes.splitmix64(qq)
            h2 = hashes.splitmix64(qq ^ SALT)
            b1 = (h1 >> jnp.uint64(shift)).astype(jnp.int32)
            b2 = (h2 >> jnp.uint64(shift)).astype(jnp.int32)
            return b1 + b2, b1

        todo = {
            "pre": (f"nb=2^{nb_log} precomputed idx", pre_idx, (b1, b2, q, rows)),
            "hash": (f"nb=2^{nb_log} hash-in-graph", hash_idx, (q, rows)),
            "honly": (f"nb=2^{nb_log} bucket hash only", hash_only, (q, rows)),
        }
        for key, (name, fn, args) in todo.items():
            if part != "all" and part != key:
                continue
            dt = timed(fn, *args)
            print(
                f"{name:34s} {dt*1e3:8.2f} ms  {dt/NQ*1e9:6.1f} ns/q",
                flush=True,
            )


if __name__ == "__main__":
    main()
