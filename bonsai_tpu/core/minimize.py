"""Windowed minimizer selection as data-parallel sliding minimums.

The reference keeps a btree-multiset sliding window per sequence
(QueueMap, /root/reference/include/bonsai/qmap.h:63-97) and emits, for every
full window of W = w - c + 1 seeds, the seed minimizing (score, kmer)
lexicographically.  On the device that dissolves into a sparse-table sliding
minimum: log2(W) doubling steps plus one combine, fully vectorized over the
batch — no trees, no queues.

Two emission disciplines exist in the reference and both are reproduced:

* positional: every seed position is pushed, N-containing seeds included
  (canonical & spaced paths, encoder.h:212-217,616-628).  Emissions are the
  window minima at positions >= W-1.  No trailing partial-window emission.
* compacted: only valid seeds are pushed; the window slides over the
  subsequence of valid seeds, and a final partially-filled window emits its
  best element once (uncanonical unspaced path, encoder.h:274-306).
"""

from __future__ import annotations

import numpy as np

U64_MAX = (1 << 64) - 1


def _xp(x):
    if type(x).__module__.startswith("jax") or hasattr(x, "aval"):
        import jax.numpy as jnp

        return jnp
    return np


def _min2(s1, k1, s2, k2):
    xp = _xp(s1)
    take1 = (s1 < s2) | ((s1 == s2) & (k1 <= k2))
    return xp.where(take1, s1, s2), xp.where(take1, k1, k2)


def sliding_min(scores, kmers, W: int):
    """Minimum of (score, kmer) over each window of W consecutive positions.

    scores, kmers: (..., P) uint64.  Returns (..., P-W+1) (scores, kmers).
    Sparse-table construction: O(log W) vector ops independent of W.
    """
    P = scores.shape[-1]
    if W < 1 or P < W:
        raise ValueError(f"window {W} over {P} positions")
    if W == 1:
        return scores, kmers
    p = W.bit_length() - 1  # floor(log2(W))
    half = 1 << p
    s, k = scores, kmers
    for j in range(p):
        h = 1 << j
        s, k = _min2(s[..., :-h], k[..., :-h], s[..., h:], k[..., h:])
    # s[i] = min over [i, i+half-1]; combine the two (overlapping) halves.
    off = W - half
    if off == 0:
        return s, k
    return _min2(s[..., : -off], k[..., : -off], s[..., off:], k[..., off:])


def positional_minimizers(scores, kmers, W: int, n_push):
    """Canonical/spaced discipline: every position pushed.

    Args:
      scores, kmers: (B, P) uint64 (pad positions may hold garbage).
      W: window size in seeds (w - c + 1).
      n_push: (B,) number of real seed positions per row (len - c + 1).
    Returns:
      out_kmers: (B, P-W+1)   emission at slot j = window [j, j+W-1] min
      out_valid: (B, P-W+1)   slot j valid iff j + W <= n_push
    """
    xp = _xp(scores)
    _, out_k = sliding_min(scores, kmers, W)
    E = out_k.shape[-1]
    idx = xp.arange(E)
    out_valid = idx[None, :] < (n_push[:, None] - (W - 1))
    return out_k, out_valid


def compact_valid(scores, kmers, valid):
    """Stable-compact valid entries to the row front; tail = sentinel
    (score=kmer=U64_MAX, matching the qmap not-full sentinel domain)."""
    xp = _xp(scores)
    B, P = scores.shape
    sentinel = xp.uint64(U64_MAX)
    dest = xp.cumsum(valid.astype(xp.int32), axis=-1) - 1
    dest = xp.where(valid, dest, P)  # dropped
    rows = xp.arange(B)[:, None].repeat(P, axis=-1) if xp is np else None
    if xp is np:
        cs = np.full((B, P + 1), sentinel, dtype=np.uint64)
        ck = np.full((B, P + 1), sentinel, dtype=np.uint64)
        cs[rows, dest] = np.where(valid, scores, sentinel)
        ck[rows, dest] = np.where(valid, kmers, sentinel)
        return cs[:, :P], ck[:, :P]
    import jax.numpy as jnp

    cs = jnp.full((B, P), sentinel, dtype=jnp.uint64)
    ck = jnp.full((B, P), sentinel, dtype=jnp.uint64)
    rows = jnp.arange(B)[:, None]
    cs = cs.at[rows, dest].set(jnp.where(valid, scores, sentinel), mode="drop")
    ck = ck.at[rows, dest].set(jnp.where(valid, kmers, sentinel), mode="drop")
    return cs, ck


def compacted_minimizers(scores, kmers, valid, W: int):
    """Uncanonical discipline: only valid seeds pushed; window slides over
    the valid subsequence; one trailing emission for a final partial window
    (qmap partially_full, encoder.h:304-306).

    Returns:
      out_kmers: (B, P-W+1) window minima over compacted valid seeds
      out_valid: (B, P-W+1) slot j valid iff j + W <= n_valid
      tail_kmer: (B,) best of all pushed seeds
      tail_valid:(B,) True iff 0 < n_valid < W
    """
    xp = _xp(scores)
    n_valid = valid.sum(axis=-1).astype(xp.int32)
    cs, ck = compact_valid(scores, kmers, valid)
    P = cs.shape[-1]
    if P >= W:
        ws, wk = sliding_min(cs, ck, W)
        E = wk.shape[-1]
        idx = xp.arange(E)
        out_valid = idx[None, :] < (n_valid[:, None] - (W - 1))
        out_k = wk
    else:
        out_k = xp.zeros(cs.shape[:-1] + (0,), dtype=xp.uint64)
        out_valid = xp.zeros(cs.shape[:-1] + (0,), dtype=bool)
    # trailing partial window: min over all pushed (sentinel tail loses all
    # comparisons except all-sentinel rows, which are masked by tail_valid).
    ts, tk = sliding_min(cs, ck, P)
    tail_kmer = tk[..., 0]
    tail_valid = (n_valid > 0) & (n_valid < W)
    return out_k, out_valid, tail_kmer, tail_valid
