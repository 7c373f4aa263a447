#!/usr/bin/env python
"""Stamp the routed probe's per-round LOCAL routing work on one chip.

Measures exactly the per-round work every rank does in
parallel/sharded.py::routed_probe EXCEPT the all_to_all and the table
probe (single chip has no mesh): key build, sort, searchsorted segment
boundaries, gather-built send, the slotq response-map scatter, and the
response gather + merge.  Variants isolate where the time goes:

  full        — legacy scan-rank formulation (associative_scan run
                starts; kept as the r4-session-1 measurement baseline)
  segrank     — rank read off seg boundaries (the r4 production path)
  v2          — round-5 candidate: dual-operand sort carries kq (no
                Q-sized kq gather), seg starts broadcast into the
                (ndb, cap) send frame (no seg[o_j] gathers), slotq
                built by a DUMP-frame scatter (no Q-frame rank/take)
  v2direct    — v2 with the response delivered by scattering `back`
                directly to query positions (no slotq, no response
                gather; pays a second DUMP scatter for `newly`)
  v3          — v2 with a u32 sort key (owner<<27|iota) — measured
                SLOWER than the u64 dual sort (XLA pads mixed-width
                operand sorts); kept as the negative result
  v5          — v2 + the two DUMP gathers fused into ONE (Q,2) row
                gather, maskless send, concat-free response merge —
                THE PRODUCTION FORMULATION since round 5
  v5send      — v5 cut after the send build (send-side component cost)
  sort2only   — dual-operand (key, kq) sort floor
  sort32only  — (u32 key, u64 kq) sort floor (negative result)
  noscatter   — slotq scatter replaced by a same-size gather (LOWER
                BOUND on what removing the last scatter could buy; not
                a correct program, timing only)
  sortonly    — just the key build + single-operand sort floor

Run under `timeout`; every shape compiles the same production ops (no
one-hot broadcast-reduce anywhere).

Prints one JSON line per (shape, variant).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bonsai_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp


def make_round(Q: int, ndb: int, cf: float, variant: str):
    cap = max(int(np.ceil(Q / ndb * cf)), 1)
    DUMP = ndb * cap
    U32 = jnp.uint64(0xFFFFFFFF)
    SENT = jnp.uint64(0xFFFFFFFFFFFFFFFF)

    def rnd(kq, owner, pending, back):
        iota = jnp.arange(Q, dtype=jnp.uint64)
        pos = jnp.arange(Q, dtype=jnp.int32)
        key = jnp.where(
            pending,
            (owner.astype(jnp.uint64) << jnp.uint64(32)) | iota,
            SENT,
        )
        if variant in ("v3", "sort32only"):
            # u32 sort key: owner (high bits) | iota — halves the key
            # bytes through the sort; kq rides as the u64 payload.
            # Valid for Q < 2^27 with ndb <= 32 (shift = 32 - 5).
            key32 = jnp.where(
                pending,
                (owner.astype(jnp.uint32) << jnp.uint32(27))
                | jnp.arange(Q, dtype=jnp.uint32),
                jnp.uint32(0xFFFFFFFF),
            )
            skey32, skq = jax.lax.sort((key32, kq), num_keys=1)
            if variant == "sort32only":
                return skey32.sum().astype(jnp.uint64) + skq.sum()
            sidx = (skey32 & jnp.uint32(0x07FFFFFF)).astype(jnp.int32)
            sowner_u = skey32 >> jnp.uint32(27)
            seg = jnp.searchsorted(
                sowner_u, jnp.arange(ndb + 1, dtype=jnp.uint32)
            ).astype(jnp.int32)
            src2 = (
                seg[:ndb, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
            ).reshape(DUMP)
            end2 = jnp.broadcast_to(seg[1:, None], (ndb, cap)).reshape(DUMP)
            valid_j = src2 < end2
            src_safe = jnp.minimum(src2, Q - 1)
            send = jnp.where(valid_j, skq[src_safe], jnp.uint64(0))
            qidx_j = sidx[src_safe]
            jdump = jnp.arange(DUMP, dtype=jnp.int32)
            slotq = (
                jnp.full((Q,), DUMP, jnp.int32)
                .at[jnp.where(valid_j, qidx_j, Q)]
                .set(jdump, mode="drop")
            )
            back1 = jnp.concatenate([back, jnp.zeros((1,), jnp.uint64)])
            res = back1[slotq]
            newly = slotq < DUMP
            res = jnp.where(newly, res, jnp.uint64(0))
            return send.sum() + res.sum() + newly.sum().astype(jnp.uint64)
        if variant in ("v5", "v5send"):
            # v2 + the two DUMP-sized gathers (send kq, query idx)
            # fused into ONE row gather from a (Q, 2) u64 matrix; send
            # mask dropped (rows past a segment end carry stale keys —
            # their responses are never read); back1 concat replaced by
            # clamp + where.
            skey, skq = jax.lax.sort((key, kq), num_keys=1)
            sidx = (skey & U32).astype(jnp.int32)
            sowner_u = (skey >> jnp.uint64(32)).astype(jnp.uint32)
            seg = jnp.searchsorted(
                sowner_u, jnp.arange(ndb + 1, dtype=jnp.uint32)
            ).astype(jnp.int32)
            src2 = (
                seg[:ndb, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
            ).reshape(DUMP)
            end2 = jnp.broadcast_to(seg[1:, None], (ndb, cap)).reshape(DUMP)
            valid_j = src2 < end2
            src_safe = jnp.minimum(src2, Q - 1)
            both = jnp.stack([skq, sidx.astype(jnp.uint64)], axis=1)
            g = both[src_safe]  # (DUMP, 2): [kq, qidx]
            send = g[:, 0]
            qidx_j = g[:, 1].astype(jnp.int32)
            if variant == "v5send":
                return send.sum() + qidx_j.sum().astype(jnp.uint64)
            jdump = jnp.arange(DUMP, dtype=jnp.int32)
            slotq = (
                jnp.full((Q,), DUMP, jnp.int32)
                .at[jnp.where(valid_j, qidx_j, Q)]
                .set(jdump, mode="drop")
            )
            newly = slotq < DUMP
            res = jnp.where(
                newly, back[jnp.minimum(slotq, DUMP - 1)], jnp.uint64(0)
            )
            return send.sum() + res.sum() + newly.sum().astype(jnp.uint64)
        if variant == "sort2only":
            skey, skq = jax.lax.sort(
                (jnp.where(
                    pending,
                    (owner.astype(jnp.uint64) << jnp.uint64(32)) | iota,
                    SENT,
                ), kq), num_keys=1,
            )
            return skey.sum() + skq.sum()
        if variant in ("v2", "v2direct"):
            # dual-operand sort: kq rides along, so the sorted queries
            # come out of the sort instead of a Q-sized u64 gather
            skey, skq = jax.lax.sort((key, kq), num_keys=1)
            sidx = (skey & U32).astype(jnp.int32)
            sowner_u = (skey >> jnp.uint64(32)).astype(jnp.uint32)
            seg = jnp.searchsorted(
                sowner_u, jnp.arange(ndb + 1, dtype=jnp.uint32)
            ).astype(jnp.int32)
            # send frame (ndb, cap): owner o's r-th query sits at
            # seg[o]+r.  seg starts/ends broadcast — no per-row gather
            src2 = (
                seg[:ndb, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
            ).reshape(DUMP)
            end2 = jnp.broadcast_to(seg[1:, None], (ndb, cap)).reshape(DUMP)
            valid_j = src2 < end2
            src_safe = jnp.minimum(src2, Q - 1)
            send = jnp.where(valid_j, skq[src_safe], jnp.uint64(0))
            qidx_j = sidx[src_safe]
            jdump = jnp.arange(DUMP, dtype=jnp.int32)
            if variant == "v2direct":
                res = (
                    jnp.zeros((Q,), jnp.uint64)
                    .at[jnp.where(valid_j, qidx_j, Q)]
                    .set(back, mode="drop")
                )
                newly = (
                    jnp.zeros((Q,), bool)
                    .at[jnp.where(valid_j, qidx_j, Q)]
                    .set(True, mode="drop")
                )
            else:
                slotq = (
                    jnp.full((Q,), DUMP, jnp.int32)
                    .at[jnp.where(valid_j, qidx_j, Q)]
                    .set(jdump, mode="drop")
                )
                back1 = jnp.concatenate(
                    [back, jnp.zeros((1,), jnp.uint64)]
                )
                res = back1[slotq]
                newly = slotq < DUMP
            res = jnp.where(newly, res, jnp.uint64(0))
            return send.sum() + res.sum() + newly.sum().astype(jnp.uint64)
        skey = jnp.sort(key)
        if variant == "sortonly":
            return skey.sum()
        p_sorted = skey != SENT
        sowner = (skey >> jnp.uint64(32)).astype(jnp.int32)
        sidx = (skey & U32).astype(jnp.int32)
        sowner_u = (skey >> jnp.uint64(32)).astype(jnp.uint32)
        seg = jnp.searchsorted(
            sowner_u, jnp.arange(ndb + 1, dtype=jnp.uint32)
        ).astype(jnp.int32)
        if variant == "segrank":
            rank = pos - seg[jnp.minimum(sowner, ndb - 1)]
        else:
            first = jnp.concatenate(
                [jnp.ones((1,), bool), sowner[1:] != sowner[:-1]]
            )
            run_start = jax.lax.associative_scan(
                jnp.maximum, jnp.where(first, pos, 0)
            )
            rank = pos - run_start
        take = p_sorted & (rank < cap)
        slot = jnp.where(take, sowner * cap + rank, DUMP)
        safe_sidx = jnp.minimum(sidx, Q - 1)
        jdump = jnp.arange(DUMP, dtype=jnp.int32)
        o_j = jdump // cap
        r_j = jdump % cap
        src = seg[o_j] + r_j
        valid_j = src < seg[o_j + 1]
        sorted_kq = kq[safe_sidx]
        send = jnp.where(
            valid_j, sorted_kq[jnp.minimum(src, Q - 1)], jnp.uint64(0)
        )
        if variant == "noscatter":
            # timing stand-in: a Q-sized gather instead of the scatter
            slotq = jnp.minimum(pos, DUMP)
        else:
            slotq = (
                jnp.full((Q,), DUMP, jnp.int32)
                .at[jnp.where(take, sidx, Q)]
                .set(slot, mode="drop")
            )
        back1 = jnp.concatenate([back, jnp.zeros((1,), jnp.uint64)])
        got = back1[slotq]
        newly = slotq < DUMP
        res = jnp.where(newly, got, jnp.uint64(0))
        return send.sum() + res.sum() + newly.sum().astype(jnp.uint64)

    return jax.jit(rnd)


def main():
    dev = jax.devices()[0]
    print(json.dumps({"device": str(dev)}), flush=True)
    rng = np.random.default_rng(0)
    shapes = [(75776, 4), (75776, 8), (18944, 8)]
    for Q, ndb in shapes:
        kq = jnp.asarray(rng.integers(0, 2**63, Q, dtype=np.uint64))
        owner = jnp.asarray(
            rng.integers(0, ndb, Q, dtype=np.int64).astype(np.int32)
        )
        pending = jnp.asarray(rng.random(Q) < 0.97)
        cap = max(int(np.ceil(Q / ndb * 1.25)), 1)
        back = jnp.asarray(
            rng.integers(0, 2**63, ndb * cap, dtype=np.uint64)
        )
        variants = os.environ.get(
            "A2A_VARIANTS",
            "full,segrank,v2,v2direct,noscatter,sortonly",
        ).split(",")
        for variant in variants:
            fn = make_round(Q, ndb, 1.25, variant)
            out = fn(kq, owner, pending, back)
            out.block_until_ready()
            n = 30
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn(kq, owner, pending, back)
            out.block_until_ready()
            dt = (time.perf_counter() - t0) / n
            print(
                json.dumps(
                    dict(
                        metric="a2a_route_local",
                        Q=Q,
                        ndb=ndb,
                        variant=variant,
                        ms=round(dt * 1e3, 3),
                        ns_per_query=round(dt * 1e9 / Q, 1),
                    )
                ),
                flush=True,
            )


if __name__ == "__main__":
    main()
