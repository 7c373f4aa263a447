"""Windowed Shannon-entropy scoring for entropy-minimized seeds.

Equivalent of CircusEnt (/root/reference/include/bonsai/entropy.h:9-53) +
score::Entropy (encoder.h:55-58,308-346), vectorized: instead of a ring
buffer + hash-map of counts per position, per-code windowed counts come from
R cumulative sums, and H = sum_c p_c ln p_c is evaluated for every window at
once.

The reference divides the (u64) k-mer by (H + eps) in double precision and
stores the result back into a u64 score (qmap.h:79).  H is <= 0, so the
quotient is usually a large *negative* double and the double->u64 conversion
is C-UB; x86-64 compilers emit cvttsd2si-based sequences whose out-of-range
result is 0x8000000000000000.  ``f64_to_u64_x86`` reproduces that exact
semantics so entropy-minimizer selection is deterministic and matches the
reference on x86 builds.
"""

from __future__ import annotations

import numpy as np

INT64_MIN_U = 0x8000000000000000
TWO63 = 2.0 ** 63


def _xp(x):
    if type(x).__module__.startswith("jax") or hasattr(x, "aval"):
        import jax.numpy as jnp

        return jnp
    return np


def f64_to_u64_x86(x):
    """C-style (uint64_t)double with x86-64 gcc semantics."""
    xp = _xp(x)
    big = x >= TWO63
    xm = xp.where(big, x - TWO63, x)
    in_range = (xm >= -TWO63) & (xm < TWO63)
    safe = xp.where(in_range, xm, 0.0)
    i = xp.trunc(safe).astype(xp.int64)
    u = i.astype(xp.uint64)  # two's-complement bit pattern
    u = xp.where(in_range, u, xp.uint64(INT64_MIN_U))
    return xp.where(big, u ^ xp.uint64(INT64_MIN_U), u)


def window_code_counts(codes, k: int, n_codes: int):
    """Counts of each code over every contiguous window of k characters.

    codes: (..., L) int8 -> (..., L-k+1, n_codes) int32 via cumulative sums.
    """
    xp = _xp(codes)
    L = codes.shape[-1]
    P = L - k + 1
    outs = []
    for c in range(n_codes):
        ind = (codes == c).astype(xp.int32)
        cum = xp.cumsum(ind, axis=-1)
        lead = cum[..., k - 1 : L]
        prev = cum[..., : P - 1]
        first = lead[..., :1]
        cnt = xp.concatenate([first, lead[..., 1:] - prev], axis=-1)
        outs.append(cnt)
    return xp.stack(outs, axis=-1)


def spaced_code_counts(codes, positions, n_codes: int):
    """Counts of each code over the k *included* seed positions
    (entropy tracker pushes per included char, encoder.h:557-575)."""
    xp = _xp(codes)
    L = codes.shape[-1]
    c_span = int(positions[-1]) + 1
    P = L - c_span + 1
    cnt = None
    for pos in positions:
        sl = codes[..., pos : pos + P]
        onehot = xp.stack([(sl == c).astype(xp.int32) for c in range(n_codes)], axis=-1)
        cnt = onehot if cnt is None else cnt + onehot
    return cnt


def entropy_value(counts, k: int):
    """H = sum_c p ln p with p = cnt/k (entropy.h:44-48; natural log,
    non-positive).

    p ln p takes only k+1 values, so they come from a float64 table that
    numpy computes on the host, and the terms are added one code at a time
    in code order (the reference's loop order).  A device's own ``log``
    need not round like the host's, and one ulp in H flips minimizer
    choices; with the table the scores are the same on every backend."""
    xp = _xp(counts)
    p = np.arange(k + 1, dtype=np.float64) / float(k)
    table = p * np.log(np.where(p > 0, p, 1.0))
    terms = xp.asarray(table)[counts]
    H = terms[..., 0]
    for c in range(1, counts.shape[-1]):
        H = H + terms[..., c]
    return H


def entropy_scores(kmers, H, eps: float):
    """score = u64( kmer / (H + eps) ) with x86 conversion semantics.

    eps = 1e-4 for the generic scorer path (encoder.h:56-58), 1e-3 for the
    fused unspaced-windowed path (encoder.h:340)."""
    xp = _xp(kmers)
    q = kmers.astype(xp.float64) / (H + eps)
    return f64_to_u64_x86(q)


ENTROPY_NOT_FULL = -1.0  # CircusEnt::NOT_FULL — partial seed (hit an N)
