"""128-bit k-mer packing for k in (32, 64]: (hi, lo) u64 lane pairs.

Counterpart of the reference's u128 Encoder instantiation
(encoder.h:113 with KmerT=u128; exercised by test/encoding.cpp:152-238).
Device int lanes are 32/64-bit, so a 2k-bit kmer for k > 32 is represented as
two u64 lanes (hi = bases beyond the low 32).  Canonicalization mirrors
kmerutil.h:83-146's bit-parallel reverse complement, applied lane-wise
with a cross-lane shift stitch."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _xp(x):
    if type(x).__module__.startswith("jax") or hasattr(x, "aval"):
        import jax.numpy as jnp

        return jnp
    return np


def pack_kmers128(codes, k: int) -> Tuple[object, object, object]:
    """codes: (..., L) int8 -> ((hi, lo) u64 pairs per window, invalid).

    Returns (hi (..., P), lo (..., P), invalid (..., P)) with P = L-k+1.
    """
    if not 32 < k <= 64:
        raise ValueError("pack_kmers128 requires 32 < k <= 64")
    xp = _xp(codes)
    L = codes.shape[-1]
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"k={k} > length {L}")
    c = xp.where(codes < 0, 0, codes).astype(xp.uint64)
    bad = codes < 0
    k_hi = k - 32  # bases in the high lane
    hi = xp.zeros(codes.shape[:-1] + (P,), dtype=xp.uint64)
    lo = xp.zeros(codes.shape[:-1] + (P,), dtype=xp.uint64)
    invalid = xp.zeros(codes.shape[:-1] + (P,), dtype=bool)
    # base j of the window (0 = leftmost/most significant)
    for j in range(k):
        sl = c[..., j : j + P]
        b = bad[..., j : j + P]
        if j < k_hi:
            hi = hi | (sl << xp.uint64(2 * (k_hi - 1 - j)))
        else:
            lo = lo | (sl << xp.uint64(2 * (k - 1 - j)))
        invalid = invalid | b
    return hi, lo, invalid


def _rc64(x, nbases: int):
    """Bit-parallel reverse complement of nbases 2-bit codes packed at the
    LOW end of a u64 (kmerutil.h:83-90)."""
    xp = _xp(x)

    def u(v):
        return xp.uint64(v)

    x = ~x
    x = ((x >> u(2)) & u(0x3333333333333333)) | ((x & u(0x3333333333333333)) << u(2))
    x = ((x >> u(4)) & u(0x0F0F0F0F0F0F0F0F)) | ((x & u(0x0F0F0F0F0F0F0F0F)) << u(4))
    x = ((x >> u(8)) & u(0x00FF00FF00FF00FF)) | ((x & u(0x00FF00FF00FF00FF)) << u(8))
    x = ((x >> u(16)) & u(0x0000FFFF0000FFFF)) | ((x & u(0x0000FFFF0000FFFF)) << u(16))
    x = (x >> u(32)) | (x << u(32))
    return x >> u(64 - 2 * nbases)


def reverse_complement128(hi, lo, k: int):
    """(hi, lo) -> reverse complement pair for k in (32, 64]."""
    xp = _xp(hi)
    k_hi = k - 32
    # reverse-complement each lane as a full-width field, then swap: the
    # rc of [HI(k_hi) LO(32)] is [rc(LO)(32 bases -> now high part) rc(HI)]
    rlo = _rc64(lo, 32)  # 32 bases
    rhi = _rc64(hi, k_hi)  # k_hi bases
    # new layout: total k bases = [rc_lo (32 bases) | rc_hi (k_hi bases)]
    # new hi lane holds the top k_hi bases of rc_lo;
    # new lo lane holds (rc_lo's remaining 32-k_hi bases) << 2*k_hi | rc_hi
    sh = xp.uint64(2 * k_hi)
    new_hi = rlo >> xp.uint64(64 - 2 * k_hi)
    new_lo = ((rlo << sh) | rhi) & (
        ~xp.uint64(0) if k_hi == 32 else xp.uint64((1 << 64) - 1)
    )
    mask_hi = xp.uint64((1 << (2 * k_hi)) - 1) if k_hi < 32 else ~xp.uint64(0)
    return new_hi & mask_hi, new_lo


def canonical128(hi, lo, k: int):
    """min(kmer, revcomp) on (hi, lo) pairs (canonical_representation,
    kmerutil.h:91-96, lexicographic on the 2k-bit integer)."""
    xp = _xp(hi)
    rhi, rlo = reverse_complement128(hi, lo, k)
    take_rc = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    return xp.where(take_rc, rhi, hi), xp.where(take_rc, rlo, lo)


def to_python_int(hi, lo) -> int:
    return (int(hi) << 64) | int(lo)
