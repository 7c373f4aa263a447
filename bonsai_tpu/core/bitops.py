"""64-bit k-mer bit operations, dual numpy/jnp.

Reverse-complement and canonicalization follow the Jellyfish/Kraken
bit-parallel recipe (reference: /root/reference/include/bonsai/kmerutil.h:83-146)
applied to whole uint64 lanes, which XLA lowers to paired 32-bit integer ops
on a GPU.  All functions accept either numpy or jax.numpy arrays (the array
namespace is inferred from the input).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
U64_MAX = (1 << 64) - 1

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF


def _xp(x):
    # jax arrays expose .device / __jax_array__; cheap duck-type check
    if type(x).__module__.startswith("jax") or hasattr(x, "aval"):
        import jax.numpy as jnp

        return jnp
    return np


def _c(xp, v):
    return xp.uint64(v)


def reverse_complement(kmer, k: int):
    """Reverse complement of a 2-bit packed DNA k-mer held in a uint64.

    Matches kmerutil.h:83-90 bit for bit, including the behavior on the
    ENCODE_OVERFLOW sentinel (all ones -> 0).
    """
    xp = _xp(kmer)
    kmer = kmer.astype(xp.uint64) if hasattr(kmer, "astype") else xp.uint64(kmer)
    kmer = ((kmer >> _c(xp, 2)) & _c(xp, _M2)) | ((kmer & _c(xp, _M2)) << _c(xp, 2))
    kmer = ((kmer >> _c(xp, 4)) & _c(xp, _M4)) | ((kmer & _c(xp, _M4)) << _c(xp, 4))
    kmer = ((kmer >> _c(xp, 8)) & _c(xp, _M8)) | ((kmer & _c(xp, _M8)) << _c(xp, 8))
    kmer = ((kmer >> _c(xp, 16)) & _c(xp, _M16)) | ((kmer & _c(xp, _M16)) << _c(xp, 16))
    kmer = (kmer >> _c(xp, 32)) | (kmer << _c(xp, 32))
    return (_c(xp, U64_MAX) - kmer) >> _c(xp, 64 - (k << 1))


def canonical(kmer, k: int):
    """min(kmer, revcomp(kmer)) — the canonical representation
    (kmerutil.h:137-140)."""
    xp = _xp(kmer)
    rc = reverse_complement(kmer, k)
    return xp.minimum(kmer, rc)


def popcount64(x):
    """Branch-free 64-bit popcount on uint64 lanes (popcnt.h equivalent)."""
    xp = _xp(x)
    x = x - ((x >> _c(xp, 1)) & _c(xp, 0x5555555555555555))
    x = (x & _c(xp, _M2)) + ((x >> _c(xp, 2)) & _c(xp, _M2))
    x = (x + (x >> _c(xp, 4))) & _c(xp, _M4)
    return (x * _c(xp, 0x0101010101010101)) >> _c(xp, 56)


def nuccount(kmer, k: int):
    """Per-base composition counts of a packed k-mer -> (..., 4) uint64.

    Bit-parallel equivalent of countInU64Ex (kmerutil.h:93-135): for each
    2-bit code c, count positions equal to c.
    """
    xp = _xp(kmer)
    mask = _c(xp, kmer_mask_bits(k))
    out = []
    for code, cmp in enumerate((0xFFFFFFFFFFFFFFFF, 0xAAAAAAAAAAAAAAAA,
                                0x5555555555555555, 0x0000000000000000)):
        x0 = kmer ^ _c(xp, cmp)
        x2 = (x0 >> _c(xp, 1)) & _c(xp, 0x5555555555555555)
        x3 = (x0 & x2) & mask
        out.append(popcount64(x3))
    return xp.stack(out, axis=-1)


def kmer_mask_bits(k: int) -> int:
    """(1 << 2k) - 1 as a python int (full mask for k == 32)."""
    return U64_MAX if k >= 32 else (1 << (2 * k)) - 1
