#!/usr/bin/env python
"""Component-level profile of the classify step on the device, with a
chained/fetch-synced harness."""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as bench_mod  # noqa: E402  (DB cache + read maker)
import bonsai_tpu  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np

from bonsai_tpu.classify.pipeline import Classifier
from bonsai_tpu.classify.resolve import resolve_batch


def _sync(x):
    leaf = jax.tree_util.tree_leaves(x)[0]
    np.asarray(jnp.ravel(leaf)[:1])


def timed(fn, *args, n=10):
    out = fn(*args)
    out = fn(*args, salt=out)  # warm the salted signature too
    _sync(out)
    t0 = time.perf_counter()
    for i in range(n):
        out = fn(*args, salt=out)
    _sync(out)
    return (time.perf_counter() - t0) / n


def main():
    B = int(os.environ.get("B", 32768))
    db, tree = bench_mod.get_db()
    clf = Classifier(db, tree)
    codes, lengths = bench_mod.make_reads(B)
    jc = jnp.asarray(codes)
    jl = jnp.asarray(lengths)
    slots, vals, inline = clf._arrays
    enc = clf.enc
    table = db.table
    tax = clf._tax

    def salt_codes(jc, salt):
        leaf = jax.tree_util.tree_leaves(salt)[0]
        s = jnp.ravel(leaf)[0].astype(jnp.int8) % 4
        return jc.at[:, -1].set(s)

    @jax.jit
    def enc_only(jc, jl, slots, vals, salt=0):
        em = enc.emissions(salt_codes(jc, salt), jl)
        return em.values, em.mask

    @jax.jit
    def enc_probe(jc, jl, slots, vals, salt=0):
        em = enc.emissions(salt_codes(jc, salt), jl)
        v, f = table.probe_device(em.values, arrays=(slots, vals, inline))
        return v, f, em.mask

    @jax.jit
    def enc_probe_resolve(jc, jl, slots, vals, salt=0):
        em = enc.emissions(salt_codes(jc, salt), jl)
        packed, found = table.probe_device(
            em.values, arrays=(slots, vals, inline)
        )
        cidx = (packed & jnp.uint64(0xFFFFFFFF)).astype(jnp.int32)
        hit = em.mask & found
        cidx = jnp.where(hit, cidx, 0)
        return resolve_batch(cidx, hit, tax)

    @jax.jit
    def full(jc, jl, slots, vals, salt=0):
        return clf._step()[0](salt_codes(jc, salt), jl, slots, vals)

    parts = {
        "encode": ("encode only", enc_only),
        "probe": ("encode+probe", enc_probe),
        "resolve": ("encode+probe+resolve", enc_probe_resolve),
        "full": ("full step", full),
    }
    sel = os.environ.get("PART")
    for key, (name, fn) in parts.items():
        if sel and key != sel:
            continue
        dt = timed(fn, jc, jl, slots, vals)
        print(f"{name:24s} {dt*1e3:8.2f} ms  ({B/dt/1e3:.0f} kreads/s)",
              flush=True)


if __name__ == "__main__":
    main()
