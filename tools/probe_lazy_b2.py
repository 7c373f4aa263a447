#!/usr/bin/env python
"""Probe experiment: displacement-bit lazy b2 + cumsum compaction.

One more attempt at the single-gather ceiling (the b1-only step, an
incorrect upper bound on the dual-gather step).  Design under test:

* placement skew: after cuckoo placement, move every b2-resident key back
  to its b1 bucket whenever a slot is free (host post-pass), maximizing
  b1-resolved probes;
* displacement bit: slot 0 of each bucket donates one VALUE bit
  (DISPBIT).  Set <=> some key whose PRIMARY bucket is this one lives at
  its b2, OR slot 0 is unoccupied while the bucket is nonempty
  (conservative).  A query that misses its b1 row AND sees DISPBIT clear
  (with slot0 occupied) is a PROVEN table miss — no b2 gather needed.
  Matching is unchanged (the bit sits inside the value mask); only
  slot-0 value extraction masks it out.
* compaction: the residual b2-needing lanes (b2-resident hits +
  displaced-bucket misses) compact into a CAP-sized buffer via a
  two-level exclusive cumsum (block-row sums + small cross-row scan — no
  argsort, no jnp.nonzero reduce-window blowup), one scatter, CAP row
  gathers, one gather back.

Measures, end-to-end in the real step shape (8192 x 101bp reads, ec k=31
DB), interleaved + repeated:
  v0: current dual-gather step
  v1: lazy-b2 at several CAP fractions
and prints host-side placement stats (b1-resident %, displaced-bucket %,
expected b2-need %).
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import bench as bench_mod  # noqa: E402
import bonsai_tpu  # noqa: F401,E402


def b1_prefer_pass(table) -> int:
    """Host post-pass: move b2-resident keys into a free b1 slot.
    Returns the number moved.  Any valid placement probes identically."""
    moved_total = 0
    from bonsai_tpu.db.table import SLOTS

    b1 = (table._h & np.uint64(table.nb - 1)).astype(np.int64)
    for _ in range(SLOTS):
        owner = table.owner
        occ = owner >= 0
        at_b2 = (table.choice == 1) & occ
        if not at_b2.any():
            break
        grid = owner.reshape(table.nb, SLOTS)
        has_free = (grid < 0).any(1)
        free_lane = np.argmax(grid < 0, axis=1)
        keys_b2 = owner[at_b2]
        want = b1[keys_b2]
        ok = has_free[want]
        cand_slots = np.nonzero(at_b2)[0][ok]
        cand_keys = keys_b2[ok]
        cand_b1 = want[ok]
        # one move per target bucket per round: moves are then disjoint
        # (unique dst bucket+lane; src slots all distinct and occupied)
        uniqb, first = np.unique(cand_b1, return_index=True)
        dst = uniqb * SLOTS + free_lane[uniqb]
        src = cand_slots[first]
        owner[dst] = cand_keys[first]
        table.choice[dst] = 0
        owner[src] = -1
        table.choice[src] = 0
        moved_total += len(uniqb)
        table._finalize()
        if len(uniqb) == 0:
            break
    return moved_total


def encode_slots_disp(table, packed_vals):
    """(slots, uniq, dispbit) with DISPBIT in slot0's value field."""
    from bonsai_tpu.db.table import SLOTS, _OCC

    v64 = packed_vals.astype(np.uint64)
    uniq = np.unique(v64)
    vbits = table.vbits
    assert uniq.size <= (1 << (vbits - 1)), "needs one spare value bit"
    occ = table.occ_mask
    words = np.zeros(table.nb * SLOTS, dtype=np.uint64)
    own = table.owner[occ]
    q = table._h[own] >> np.uint64(table.lgnb)
    w = (
        _OCC
        | (table.choice[occ].astype(np.uint64) << np.uint64(62))
        | (q << np.uint64(vbits))
        | np.searchsorted(uniq, v64[own]).astype(np.uint64)
    )
    words[occ] = w
    slots = words.reshape(table.nb, SLOTS)
    # displaced(b): some key with b1 == b lives at its b2
    b1 = (table._h & np.uint64(table.nb - 1)).astype(np.int64)
    disp = np.zeros(table.nb, dtype=bool)
    at_b2 = table.choice[occ] == 1
    disp[b1[own[at_b2]]] = True
    # conservative: slot0 empty but bucket nonempty -> treat as displaced
    s0_occ = occ.reshape(table.nb, SLOTS)[:, 0]
    nonempty = occ.reshape(table.nb, SLOTS).any(1)
    force = (~s0_occ) & nonempty
    DISPBIT = np.uint64(1) << np.uint64(vbits - 1)
    slots[:, 0] = np.where(
        s0_occ & disp, slots[:, 0] | DISPBIT, slots[:, 0]
    )
    stats = dict(
        b1_resident=float((table.choice[occ] == 0).mean()),
        displaced_buckets=float(disp.mean()),
        forced_conservative=float(force.mean()),
    )
    return slots, uniq, int(DISPBIT), stats


def make_steps(clf, slots_d, uniq_d, dispbit, cap_frac, sort_compact=False):
    """v1 step: b1 gather + dispbit-gated compacted b2 gather."""
    import jax
    import jax.numpy as jnp

    from bonsai_tpu.core import hashes as hsh
    from bonsai_tpu.db.table import SLOTS, KmerTable, BSALT

    SORT_COMPACT = sort_compact
    table = clf.db.table
    enc = clf.enc
    tax = clf._tax
    lgnb, vbits = table.lgnb, table.vbits
    DISP = jnp.uint64(dispbit)
    vmask = jnp.uint64((1 << vbits) - 1)
    vmask_lane = jnp.array(
        [(1 << (vbits - 1)) - 1] + [(1 << vbits) - 1] * (SLOTS - 1),
        dtype=jnp.uint64,
    )

    def probe_lazy(kq, slots, uniq, CAP):
        h = hsh.splitmix64(kq)
        b1, q, b2 = KmerTable._split(h, lgnb, xp=jnp)
        base = jnp.uint64(1 << 63) | (q << jnp.uint64(vbits))
        e1 = base
        e2 = base | jnp.uint64(1 << 62)
        row1 = slots[b1.astype(jnp.int32)]
        m1 = (row1 & ~vmask) == e1[..., None]
        hit1 = jnp.any(m1, -1)
        s1 = jnp.sum(
            jnp.where(m1, (row1 & vmask_lane).astype(jnp.uint32), 0), -1
        )
        conclusive = ((row1[..., 0] & jnp.uint64(1 << 63)) != 0) & (
            (row1[..., 0] & DISP) == 0
        )
        need = (~hit1) & ~conclusive
        Q = kq.shape[0]
        # two-level exclusive cumsum of `need` (R x C layout)
        C = 128
        R = Q // C
        x = need.reshape(R, C).astype(jnp.int32)
        inrow = jnp.cumsum(x, axis=1) - x
        rowsum = x.sum(1)
        rowoff = jnp.cumsum(rowsum) - rowsum
        pos = rowoff[:, None] + inrow
        idx = jnp.where(need.reshape(R, C), pos, CAP).reshape(-1)
        if SORT_COMPACT:
            # scatter-free: sort (need?iota:BIG) ascending; the first
            # n_need entries are the needing lanes in iota order — the
            # same compact order as the cumsum ranks
            iota = jnp.arange(Q, dtype=jnp.uint64)
            skey = jnp.sort(
                jnp.where(need, iota, jnp.uint64(0xFFFFFFFFFFFFFFFF))
            )[:CAP]
            sidx = jnp.minimum(skey, jnp.uint64(Q - 1)).astype(jnp.int32)
            sendq = jnp.where(
                skey != jnp.uint64(0xFFFFFFFFFFFFFFFF), kq[sidx],
                jnp.uint64(0),
            )
        else:
            sendq = (
                jnp.zeros(CAP + 1, jnp.uint64).at[idx].set(kq, mode="drop")
            )[:CAP]
        # recompute b2 for the compact stream (compute is free)
        h2 = hsh.splitmix64(sendq)
        b1c, qc, b2c = KmerTable._split(h2, lgnb, xp=jnp)
        e2c = (
            jnp.uint64(1 << 63)
            | (qc << jnp.uint64(vbits))
            | jnp.uint64(1 << 62)
        )
        row2 = slots[b2c.astype(jnp.int32)]
        m2 = (row2 & ~vmask) == e2c[..., None]
        hit2c = jnp.any(m2, -1)
        s2c = jnp.sum(
            jnp.where(m2, (row2 & vmask_lane).astype(jnp.uint32), 0), -1
        )
        packed2 = (
            hit2c.astype(jnp.uint32) << jnp.uint32(31)
        ) | s2c
        back = jnp.concatenate([packed2, jnp.zeros(1, jnp.uint32)])[idx]
        hit2 = (back >> jnp.uint32(31)) != 0
        s2 = back & jnp.uint32(0x7FFFFFFF)
        hit2 = hit2.reshape(Q) & need
        found = hit1 | hit2
        sel = jnp.where(hit1, s1, jnp.where(hit2, s2.reshape(Q), 0))
        val = uniq[sel.astype(jnp.int32)]
        val = jnp.where(found, val, 0)
        n_need = rowsum.sum()
        return val, found, n_need

    from bonsai_tpu.classify.resolve import resolve_batch

    maxr = clf.max_runs

    def step(codes, lengths, slots, uniq):
        em = enc.emissions(codes, lengths)
        kmers, valid = em.values, em.mask
        B, P = kmers.shape
        CAP = max(int(B * P * cap_frac) // 128 * 128, 128)
        packed, found, n_need = probe_lazy(
            kmers.reshape(-1), slots, uniq, CAP
        )
        packed = packed.reshape(B, P)
        found = found.reshape(B, P)
        cidx = (packed & jnp.uint64(0xFFFFFFFF)).astype(jnp.int32)
        oidx = (packed >> jnp.uint64(32)).astype(jnp.uint32)
        hit = valid & found
        miss = valid & ~hit
        cidx = jnp.where(hit, cidx, 0)
        taxon_c = resolve_batch(cidx, hit, tax)
        taxon = tax["tax_ids"][taxon_c].astype(jnp.uint32)
        head = jnp.stack(
            [taxon, miss.sum(-1).astype(jnp.uint32),
             valid.sum(-1).astype(jnp.uint32), n_need.astype(jnp.uint32)
             * jnp.ones(B, jnp.uint32)],
            axis=1,
        )
        return head

    return jax.jit(step)


def time_step(fn, args0, salt_col, steps=20):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(codes, lengths, a, b, salt):
        codes = codes.at[:, -1].set((salt[: codes.shape[0]] % 4).astype(codes.dtype))
        return fn(codes, lengths, a, b)

    codes, lengths, a, b = args0
    out = chained(codes, lengths, a, b, jnp.zeros(codes.shape[0], jnp.uint32))
    np.asarray(out.ravel()[:1])
    for _ in range(25):
        out = chained(codes, lengths, a, b, out[:, salt_col])
    np.asarray(out.ravel()[:1])
    t0 = time.time()
    for _ in range(steps):
        out = chained(codes, lengths, a, b, out[:, salt_col])
    np.asarray(out.ravel()[:1])
    return (time.time() - t0) / steps, out


def main():
    import jax
    import jax.numpy as jnp

    db, tree = bench_mod.get_db()
    from bonsai_tpu.classify.pipeline import Classifier

    clf = Classifier(db, tree)
    table = db.table
    moved = b1_prefer_pass(table)
    packed = (
        table.vals_sorted.astype(np.uint64) << np.uint64(32)
    ) | tree.compact(table.vals_sorted, missing_ok=True).astype(np.uint64)
    slots_np, uniq_np, dispbit, stats = encode_slots_disp(table, packed)
    print(f"b1-prefer moved {moved}; stats: {stats}", file=sys.stderr)

    batch = int(os.environ.get("BENCH_BATCH", 8192))
    codes, lengths = bench_mod.make_reads(batch)
    jc, jl = jnp.asarray(codes), jnp.asarray(lengths)
    slots_d = jnp.asarray(slots_np)
    uniq_d = jnp.asarray(uniq_np)

    # v0 baseline: the production step (compact output head col 0)
    step0 = clf._step()[0]
    s0, v0, _ = clf._arrays

    def v0fn(c, l, a, b):
        return step0(c, l, a, b)[0]

    variants = [("v0 dual-gather", v0fn, (jc, jl, s0, v0), 0)]
    for frac in (0.25, 0.125):
        fn = make_steps(clf, slots_d, uniq_d, dispbit, frac)
        variants.append((f"v1 lazy-b2 cap={frac}", fn,
                         (jc, jl, slots_d, uniq_d), 0))
    fn = make_steps(clf, slots_d, uniq_d, dispbit, 0.125, sort_compact=True)
    variants.append(("v2 lazy-b2 sort cap=0.125", fn,
                     (jc, jl, slots_d, uniq_d), 0))

    # correctness first: lazy-b2 must match the production step exactly
    # (v0's compact head packs counters as u16 pairs since round 3:
    # col0 = taxon, col1 = miss | kmers<<16)
    cm = np.asarray(v0fn(jc, jl, s0, v0))
    ref = np.stack(
        [cm[:, 0], cm[:, 1] & 0xFFFF, cm[:, 1] >> 16], axis=1
    )
    for name, fn, args, _ in variants[1:]:
        got = np.asarray(fn(*args))[:, :3]
        assert np.array_equal(got, ref), f"{name} diverges from v0"
    print("correctness: lazy-b2 == v0 on the bench batch", file=sys.stderr)

    # interleave, 3 reps, report min
    results = {name: [] for name, *_ in variants}
    for rep in range(3):
        for name, fn, args, col in variants:
            dt, out = time_step(fn, args, col)
            results[name].append(dt * 1e3)
            if "lazy" in name and rep == 0:
                n_need = int(np.asarray(out)[0, 3])
                print(f"  {name}: n_need={n_need} "
                      f"({n_need / (batch * (101 - 30)):.1%} of Q)",
                      file=sys.stderr)
    print()
    for name, ms in results.items():
        best = min(ms)
        print(f"{name:28s} {best:7.2f} ms/step  "
              f"({batch / best * 1e3:,.0f} reads/s)  all={['%.1f' % m for m in ms]}")


if __name__ == "__main__":
    main()
