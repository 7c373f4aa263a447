"""Batched resolve_tree on device.

The reference walks parent pointers per distinct hit taxon
(util.h:831-869).  With Euler-tour interval labels the leaf-to-root path
weight of taxon t over the hit multiset Q is a pairwise ancestor test:

    score(t) = #{q in Q : tin[q] <= tin[t] <= tout[q]}

evaluated as a dense (P, P) comparison matrix per read — at P ~ 100-300
hit positions that is ~1e8 boolean ops per large batch, fuses into a
handful of elementwise kernels, and avoids data-dependent sorts entirely.

Tie resolution (max-score set -> LCA of the set) uses the preorder-interval
fact LCA(S) = LCA(argmin tin, argmax tin), computed by vectorized binary
lifting over the whole batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lca_device(a_idx, b_idx, tax):
    """Vectorized pairwise LCA over compact indices (0 = none).

    tax: TaxTree.device_arrays() dict (parent, depth, lift)."""
    lift, depth = tax["lift"], tax["depth"]
    a = a_idx.astype(jnp.int32)
    b = b_idx.astype(jnp.int32)
    a0, b0 = a, b
    da = depth[a]
    db = depth[b]
    levels = lift.shape[0]
    for j in range(levels - 1, -1, -1):
        step = 1 << j
        la = (da - db) >= step
        a = jnp.where(la, lift[j][a], a)
        da = jnp.where(la, da - step, da)
        lb = (db - da) >= step
        b = jnp.where(lb, lift[j][b], b)
        db = jnp.where(lb, db - step, db)
    neq = a != b
    for j in range(levels - 1, -1, -1):
        pa = lift[j][a]
        pb = lift[j][b]
        move = neq & (pa != pb)
        a = jnp.where(move, pa, a)
        b = jnp.where(move, pb, b)
    res = jnp.where(neq, tax["parent"][a], a)
    res = jnp.where(a0 == 0, b0, res)
    res = jnp.where(b0 == 0, jnp.where(a0 == 0, 0, a0), res)
    return res


def resolve_batch(hit_idx, hit_mask, tax, block: int = 1024,
                  n_distinct: int | None = None):
    """hit_idx: (B, P) compact taxonomy indices of DB hits; hit_mask: (B, P).

    Returns (B,) compact index of the resolved taxon (0 = unclassified).

    For short reads the (B, P, P) ancestor matrix materializes whole.

    For LONG reads (multi-kb nanopore-style inputs, which the reference's
    linear per-read loop handles at any length) the dense matrix is
    asymptotically wrong — the reference resolves over DISTINCT taxa
    (util.h:831-869), of which a read can hit at most D = ``n_distinct``
    (the DB's distinct-value count, known statically by every caller).
    When P is large and D ≪ P, each row is sorted and deduplicated to D
    slots with multiplicity counts, and the ancestor matrix runs at
    (B, D, D) with count weights — bit-identical scores, O(P log P + D²)
    per read instead of O(P²).

    Without ``n_distinct`` (or when D is not small), P > ``block`` falls
    back to scanning the q axis in blocks: memory O(B * block * P), work
    still O(P²)."""
    tin, tout = tax["tin"], tax["tout"]
    B, P = hit_idx.shape
    n = tin.shape[0]
    BIG = jnp.int32(n + 2)
    if (
        n_distinct is not None
        and n_distinct > 0  # 0 = empty DB: nothing can hit, use dense
        and P > 256
        and min(n_distinct, P) <= P // 2
    ):
        return _resolve_dedup(
            hit_idx, hit_mask, tax, min(int(n_distinct), P)
        )
    t_in = jnp.where(hit_mask, tin[hit_idx], BIG)
    t_out = jnp.where(hit_mask, tout[hit_idx], -2)
    if P <= block:
        # anc[b, q, p]: hit q is an ancestor-or-self of hit p
        anc = (t_in[:, :, None] <= t_in[:, None, :]) & (
            t_in[:, None, :] <= t_out[:, :, None]
        )
        score = jnp.sum(anc, axis=1).astype(jnp.int32)
    else:
        nblk = -(-P // block)
        Ppad = nblk * block
        ti_q = jnp.pad(t_in, ((0, 0), (0, Ppad - P)), constant_values=BIG)
        to_q = jnp.pad(t_out, ((0, 0), (0, Ppad - P)), constant_values=-2)
        ti_q = ti_q.reshape(B, nblk, block)
        to_q = to_q.reshape(B, nblk, block)

        def add_block(score, qs):
            ti_b, to_b = qs  # (B, block)
            anc = (ti_b[:, :, None] <= t_in[:, None, :]) & (
                t_in[:, None, :] <= to_b[:, :, None]
            )
            return score + jnp.sum(anc, axis=1).astype(jnp.int32), None

        score0 = jnp.zeros((B, P), dtype=jnp.int32)
        score, _ = jax.lax.scan(
            add_block,
            score0,
            (jnp.moveaxis(ti_q, 1, 0), jnp.moveaxis(to_q, 1, 0)),
        )
    score = jnp.where(hit_mask, score, -1)
    best = jnp.max(score, axis=-1)
    tied = (score == best[:, None]) & hit_mask
    tin_masked_min = jnp.where(tied, t_in, BIG)
    tin_masked_max = jnp.where(tied, t_in, -1)
    i_min = jnp.argmin(tin_masked_min, axis=-1)
    i_max = jnp.argmax(tin_masked_max, axis=-1)
    a = jnp.take_along_axis(hit_idx, i_min[:, None], axis=-1)[:, 0]
    b = jnp.take_along_axis(hit_idx, i_max[:, None], axis=-1)[:, 0]
    taxon = lca_device(a, b, tax)
    any_hit = jnp.any(hit_mask, axis=-1)
    return jnp.where(any_hit, taxon, 0)


def _resolve_dedup(hit_idx, hit_mask, tax, D: int):
    """Distinct-taxa resolve: per-row sort + dedup to D slots with counts,
    then the (B, D, D) count-weighted ancestor matrix.  Scores per distinct
    taxon equal the dense per-position sums exactly; the tied SET and its
    tin extrema are the same, so the LCA tie-break is bit-identical."""
    tin, tout = tax["tin"], tax["tout"]
    B, P = hit_idx.shape
    n = tin.shape[0]
    BIG = jnp.int32(n + 2)
    SENT = jnp.int32(n + 1)  # sorts after every real compact index
    sv = jnp.sort(
        jnp.where(hit_mask, hit_idx.astype(jnp.int32), SENT), axis=1
    )
    first = jnp.concatenate(
        [jnp.ones((B, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1
    ) & (sv != SENT)
    rank = jnp.cumsum(first.astype(jnp.int32), axis=1) - 1
    rows = jnp.arange(B)[:, None]
    # distinct values: scatter each run's first element to its rank slot
    # (unique targets); counts: scatter-add every valid element
    tgt_first = jnp.where(first, rank, D)
    dvals = (
        jnp.zeros((B, D + 1), jnp.int32)
        .at[rows, tgt_first]
        .set(sv, mode="drop")[:, :D]
    )
    tgt = jnp.where(sv != SENT, rank, D)
    counts = (
        jnp.zeros((B, D + 1), jnp.int32)
        .at[rows, tgt]
        .add(1, mode="drop")[:, :D]
    )
    dmask = counts > 0
    t_in = jnp.where(dmask, tin[dvals], BIG)
    t_out = jnp.where(dmask, tout[dvals], -2)
    # anc[b, q, p]: distinct q is an ancestor-or-self of distinct p
    anc = (t_in[:, :, None] <= t_in[:, None, :]) & (
        t_in[:, None, :] <= t_out[:, :, None]
    )
    score = jnp.sum(
        anc * counts[:, :, None], axis=1, dtype=jnp.int32
    )
    score = jnp.where(dmask, score, -1)
    best = jnp.max(score, axis=-1)
    tied = (score == best[:, None]) & dmask
    tin_masked_min = jnp.where(tied, t_in, BIG)
    tin_masked_max = jnp.where(tied, t_in, -1)
    i_min = jnp.argmin(tin_masked_min, axis=-1)
    i_max = jnp.argmax(tin_masked_max, axis=-1)
    a = jnp.take_along_axis(dvals, i_min[:, None], axis=-1)[:, 0]
    b = jnp.take_along_axis(dvals, i_max[:, None], axis=-1)[:, 0]
    taxon = lca_device(a, b, tax)
    any_hit = jnp.any(hit_mask, axis=-1)
    return jnp.where(any_hit, taxon, 0)
