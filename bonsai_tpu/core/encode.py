"""Batched k-mer packing: byte codes -> packed uint64 k-mers.

Vectorized design of the reference Encoder's inner loops
(/root/reference/include/bonsai/encoder.h:241-346,547-592): instead of a
rolling scalar loop, a batch of sequences is encoded with k *static* shifted
slices folded with shift-or (power-of-two radixes) or multiply-add (protein
radixes).  No gathers, no scans: XLA fuses the fold into a handful of vector ops
per position.  Ambiguous characters (code -1) are tracked with an OR-fold
validity mask; the reference's "restart on N" semantics fall out as
"windows containing an N are invalid".

All functions are dual numpy/jnp and shape-polymorphic over leading batch
dims; sequences are int8 code arrays from Alphabet.encode_bytes / a device
LUT gather.
"""

from __future__ import annotations

import numpy as np

from .alphabet import InputType, bits_of, kmer_mask, radix_of
from . import bitops

U64_MAX = (1 << 64) - 1
# Per-position sentinel for "this window contains an ambiguous base"
# (Encoder::ENCODE_OVERFLOW, encoder.h:119).
ENCODE_OVERFLOW = U64_MAX


def _xp(x):
    if type(x).__module__.startswith("jax") or hasattr(x, "aval"):
        import jax.numpy as jnp

        return jnp
    return np


def codes_from_bytes(seq_u8, lut):
    """Device-side LUT gather: (..., L) uint8 -> int8 codes (-1 ambiguous)."""
    xp = _xp(seq_u8)
    lut = xp.asarray(lut, dtype=xp.int8)
    return lut[seq_u8.astype(xp.int32)]


def pack_kmers(codes, k: int, it: InputType = InputType.DNA):
    """Contiguous k-mers.

    Args:
      codes: (..., L) int8, -1 = ambiguous/pad.
      k: seed weight; k <= chars-per-u64 for the input type.
    Returns:
      kmers:   (..., L-k+1) uint64 packed values (garbage where invalid)
      invalid: (..., L-k+1) bool, True if the window contains an ambiguous
               char.
    """
    return _pack(codes, [1] * (k - 1), it)


def pack_spaced_kmers(codes, offsets, it: InputType = InputType.DNA):
    """Spaced-seed k-mers; ``offsets`` are the k-1 per-step advances
    (Spacer.offsets).  Output width is L - c + 1 with c = 1 + sum(offsets).
    """
    return _pack(codes, list(offsets), it)


def _pack_contig_fast(codes, k, bits, xp):
    """Contiguous pack by logarithmic doubling: O(log k) shift-or steps
    (mostly in native u32 lanes) instead of k sequential u64 folds — the
    hot-path formulation on the device (the scalar rolling loop of
    encoder.h:241-272 has no carried state here at all)."""
    L = codes.shape[-1]
    P = L - k + 1
    v = xp.where(codes < 0, 0, codes).astype(xp.uint32)
    bad = codes < 0
    pieces = {1: (v, bad)}
    m = 1
    while m * 2 <= k:
        a, b = pieces[m]
        w = bits * m
        if w * 2 <= 32:
            a2 = (a[..., : a.shape[-1] - m] << xp.uint32(w)) | a[..., m:]
        else:
            a64 = a.astype(xp.uint64)
            a2 = (a64[..., : a.shape[-1] - m] << xp.uint64(w)) | a64[..., m:]
        b2 = b[..., : b.shape[-1] - m] | b[..., m:]
        m *= 2
        pieces[m] = (a2, b2)
    acc = None
    accb = None
    off = 0
    rem = k
    for m in sorted(pieces, reverse=True):
        if rem < m:
            continue
        a, b = pieces[m]
        seg = a[..., off : off + P].astype(xp.uint64)
        segb = b[..., off : off + P]
        if acc is None:
            acc, accb = seg, segb
        else:
            acc = (acc << xp.uint64(bits * m)) | seg
            accb = accb | segb
        off += m
        rem -= m
    return acc, accb


def _pack(codes, offsets, it):
    xp = _xp(codes)
    it = InputType(it)
    L = codes.shape[-1]
    c = 1 + sum(offsets)
    if L < c:
        raise ValueError(f"sequence length {L} < seed span {c}")
    P = L - c + 1
    bits = bits_of(it)
    radix = radix_of(it)

    if bits is not None and all(o == 1 for o in offsets):
        return _pack_contig_fast(codes, c, bits, xp)

    pos = 0
    sl = codes[..., 0:P]
    invalid = sl < 0
    kmer = xp.where(invalid, 0, sl).astype(xp.uint64)
    for off in offsets:
        pos += off
        sl = codes[..., pos : pos + P]
        bad = sl < 0
        invalid = invalid | bad
        v = xp.where(bad, 0, sl).astype(xp.uint64)
        if bits is not None:
            kmer = (kmer << xp.uint64(bits)) | v
        else:
            kmer = kmer * xp.uint64(radix) + v
    # k == 32 DNA etc.: fold already discards high bits; smaller k needs no
    # mask because exactly k chars were folded (matches kmer(), encoder.h:547).
    return kmer, invalid


def position_validity(lengths, P: int, span: int):
    """(B,) lengths -> (B, P) bool: position starts a full seed window
    within the (unpadded) read."""
    xp = _xp(lengths)
    idx = xp.arange(P)
    return idx[None, :] < (lengths[:, None] - (span - 1))


def canonicalize(kmers, k: int):
    """Canonical representation min(kmer, revcomp) (kmerutil.h:137-140)."""
    return bitops.canonical(kmers, k)


def overflow_to_canonical_zero(kmers, invalid, k: int):
    """Replicates the reference canon-windowed path where an N-containing
    seed becomes ENCODE_OVERFLOW and then canonical_representation maps it
    to 0 (encoder.h:622-628 with kmerutil.h:83-90): invalid -> kmer 0."""
    xp = _xp(kmers)
    canon = bitops.canonical(kmers, k)
    return xp.where(invalid, xp.uint64(0), canon)


def apply_mask(kmers, k: int, it: InputType):
    """Final mask/modulus per input type (rhtraits.h:51-68)."""
    xp = _xp(kmers)
    it = InputType(it)
    m = kmer_mask(it, k)
    if bits_of(it) is not None:
        return kmers & xp.uint64(m & U64_MAX)
    return kmers % xp.uint64(m)
