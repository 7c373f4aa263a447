#!/usr/bin/env python
"""Probe-layout microbenchmark v2 — chained iterations + scalar-fetch sync.

Each candidate is expressed as state -> state (every iteration consumes
the previous one's output).  Reports ns/query; the classify batch has ~0.3-0.5M queries.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bonsai_tpu  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np

NB = 1 << 21
NQ = 1 << 19


def _sync(x):
    leaf = jax.tree_util.tree_leaves(x)[0]
    np.asarray(jnp.ravel(leaf)[:1])


def timed_chain(fn, state, *args, n=20):
    state = fn(state, *args)
    _sync(state)
    t0 = time.perf_counter()
    for _ in range(n):
        state = fn(state, *args)
    _sync(state)
    return (time.perf_counter() - t0) / n


def report(name, dt):
    print(f"{name:52s} {dt*1e3:8.3f} ms  {dt/NQ*1e9:7.1f} ns/q", flush=True)


def main():
    print(f"devices: {jax.devices()}", flush=True)
    rng = np.random.default_rng(0)
    idx0 = jnp.asarray(rng.integers(0, NB, NQ), dtype=jnp.uint32)

    def rowtab(lanes, dtype=jnp.uint64, nb=NB):
        bits = 63 if dtype == jnp.uint64 else 31
        return jnp.asarray(
            rng.integers(0, 1 << bits, (nb, lanes)), dtype=dtype
        )

    def mk_gather(tbl, nb=NB):
        @jax.jit
        def f(idx, t):
            rows = t[(idx % nb).astype(jnp.int32)]
            return idx + rows.sum(axis=-1).astype(jnp.uint32)

        return f

    for lanes, dt_, tag in [
        (8, jnp.uint64, "64B u64x8"),
        (16, jnp.uint64, "128B u64x16"),
        (32, jnp.uint64, "256B u64x32"),
        (16, jnp.uint32, "64B u32x16"),
        (32, jnp.uint32, "128B u32x32"),
    ]:
        t = rowtab(lanes, dt_)
        d = timed_chain(mk_gather(t), idx0, t)
        report(f"1 row gather {tag}", d)

    # two independent 64B row gathers (the cuckoo pattern)
    t8 = rowtab(8)

    @jax.jit
    def two_gather(idx, t):
        i1 = (idx % NB).astype(jnp.int32)
        i2 = ((idx * jnp.uint32(2654435761)) % NB).astype(jnp.int32)
        return idx + (t[i1].sum(-1) + t[i2].sum(-1)).astype(jnp.uint32)

    report("2 independent 64B row gathers", timed_chain(two_gather, idx0, t8))

    # slice-gather: 2 consecutive 128B rows per query (256B window)
    t16 = rowtab(16)

    @jax.jit
    def window_gather(idx, t):
        i = (idx % (NB - 1)).astype(jnp.int32)
        from jax import lax

        g = lax.gather(
            t,
            i[:, None],
            lax.GatherDimensionNumbers(
                offset_dims=(1, 2),
                collapsed_slice_dims=(),
                start_index_map=(0,),
            ),
            slice_sizes=(2, 16),
            mode=lax.GatherScatterMode.CLIP,
        )
        return idx + g.sum(axis=(1, 2)).astype(jnp.uint32)

    report("1 slice-gather 2x128B rows (256B win)", timed_chain(window_gather, idx0, t16))

    # element gather u32
    flat = rowtab(16, jnp.uint32).reshape(-1)

    @jax.jit
    def elem(idx, t):
        return idx + t[(idx % (NB * 16)).astype(jnp.int32)]

    report("1 elem gather 4B", timed_chain(elem, idx0, flat))

    # sort 512k u64 (for sort-merge designs)
    q0 = jnp.asarray(rng.integers(0, 1 << 63, NQ), dtype=jnp.uint64)

    @jax.jit
    def srt(q):
        s = jnp.sort(q)
        return s ^ jnp.roll(s, 1)

    report("jnp.sort 512k u64", timed_chain(srt, q0))

    # searchsorted into 7.6M sorted u64
    keys = jnp.sort(jnp.asarray(rng.integers(0, 1 << 63, 7_600_000), dtype=jnp.uint64))

    @jax.jit
    def ss(q, k):
        i = jnp.searchsorted(k, q)
        return q + i.astype(jnp.uint64)

    report("searchsorted 512k in 7.6M", timed_chain(ss, q0, keys))

    # full probe candidate: 1-choice interleaved row, 8 keys + 8 vals u64
    tkv = rowtab(16)

    @jax.jit
    def probe1(q, t):
        h = q * jnp.uint64(0x9E3779B97F4A7C15)
        b = (h >> jnp.uint64(64 - 21)).astype(jnp.int32)
        row = t[b]
        eq = row[:, :8] == q[:, None]
        v = jnp.sum(jnp.where(eq, row[:, 8:], 0), -1)
        return q + v + jnp.uint64(1)

    report("probe: 1-choice 8k+8v interleaved 128B", timed_chain(probe1, q0, tkv))

    # full probe candidate: window slice-gather 2 rows of (8k+8v)
    @jax.jit
    def probe2(q, t):
        from jax import lax

        h = q * jnp.uint64(0x9E3779B97F4A7C15)
        b = (h >> jnp.uint64(64 - 21)).astype(jnp.int32)
        g = lax.gather(
            t,
            b[:, None],
            lax.GatherDimensionNumbers(
                offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(0,)
            ),
            slice_sizes=(2, 16),
            mode=lax.GatherScatterMode.CLIP,
        )
        keys2 = g[:, :, :8].reshape(-1, 16)
        vals2 = g[:, :, 8:].reshape(-1, 16)
        eq = keys2 == q[:, None]
        v = jnp.sum(jnp.where(eq, vals2, 0), -1)
        return q + v + jnp.uint64(1)

    report("probe: 2-row window 16k+16v slice-gather", timed_chain(probe2, q0, tkv))


if __name__ == "__main__":
    main()
