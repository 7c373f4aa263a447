"""Trusted scalar-port oracle of the reference Encoder semantics.

A deliberately slow, line-by-line faithful Python port of the dispatch and
inner loops of /root/reference/include/bonsai/encoder.h (for_each family,
qmap.h QueueMap, kmerutil.h canonicalization), used to property-test the
batched device encoder.  Not used by the framework itself.
"""

from __future__ import annotations

import math
from collections import deque

from bonsai_tpu.core.alphabet import InputType, alphabet_of, radix_of, bits_of, kmer_mask
from bonsai_tpu.core.spacer import Spacer

U64 = (1 << 64) - 1
OVERFLOW = U64
TWO63 = 2 ** 63


def frev64_py(x: int) -> int:
    x = (x ^ 0x533F8C2151B20F97) & U64
    x = (x * 0x9A98567ED20C127D) & U64
    x = ((x << 31) | (x >> 33)) & U64
    return (x ^ 0x691A9D706391077A) & U64


def revcomp_py(kmer: int, k: int) -> int:
    kmer = ((kmer >> 2) & 0x3333333333333333) | ((kmer & 0x3333333333333333) << 2)
    kmer = ((kmer >> 4) & 0x0F0F0F0F0F0F0F0F) | ((kmer & 0x0F0F0F0F0F0F0F0F) << 4)
    kmer = ((kmer >> 8) & 0x00FF00FF00FF00FF) | ((kmer & 0x00FF00FF00FF00FF) << 8)
    kmer = ((kmer >> 16) & 0x0000FFFF0000FFFF) | ((kmer & 0x0000FFFF0000FFFF) << 16)
    kmer = ((kmer >> 32) | (kmer << 32)) & U64
    return ((U64 - kmer) & U64) >> (64 - (k << 1))


def canonical_py(kmer: int, k: int) -> int:
    rc = revcomp_py(kmer, k)
    return kmer if kmer < rc else rc


def f64_to_u64_x86_py(x: float) -> int:
    big = x >= TWO63
    xm = x - TWO63 if big else x
    if math.isnan(xm) or xm < -TWO63 or xm >= TWO63:
        u = 0x8000000000000000
    else:
        u = int(xm) & U64  # python int() truncates toward zero; wrap i64->u64
    return (u ^ 0x8000000000000000) if big else u


class QMap:
    """QueueMap (qmap.h:63-97): sliding window argmin by (score, el)."""

    def __init__(self, wsz: int):
        self.wsz = wsz
        self.q = deque()

    def reset(self):
        self.q.clear()

    def next_value(self, el: int, score: int):
        self.q.append((score, el))
        if len(self.q) > self.wsz:
            self.q.popleft()
        if len(self.q) == self.wsz:
            return min(self.q)[1]
        return OVERFLOW

    def partially_full(self):
        return 0 < len(self.q) < self.wsz

    def max_in_queue(self):
        return min(self.q)[1]  # misnomer in reference: returns the best


class EntTracker:
    """CircusEnt (entropy.h:9-53)."""

    def __init__(self, k: int):
        self.k = k
        self.q = deque()

    def clear(self):
        self.q.clear()

    def push(self, c: int):
        if len(self.q) == self.k:
            self.q.popleft()
        self.q.append(c)

    def value(self) -> float:
        if len(self.q) < self.k:
            return -1.0
        qi = 1.0 / self.k
        counts = {}
        for c in self.q:
            counts[c] = counts.get(c, 0) + 1
        # sum in ascending code order, matching the vectorized reduction
        return sum(v * qi * math.log(v * qi) for _, v in sorted(counts.items()))


class OracleEncoder:
    def __init__(self, sp: Spacer, canonicalize=True, scheme="lex",
                 input_type=InputType.DNA, score_map=None):
        self.sp = sp
        self.it = InputType(input_type)
        self.scheme = scheme
        self.score_map = score_map or {}
        self.lut = alphabet_of(self.it).lut
        self.canon = bool(canonicalize) and sp.unspaced() and self.it == InputType.DNA
        self.ent = EntTracker(sp.k)

    # ---- scoring --------------------------------------------------------
    def score(self, kmer: int, ent_val: float | None, eps: float) -> int:
        if self.scheme == "lex":
            return frev64_py(kmer)
        if self.scheme == "hash":
            return self.score_map[kmer]
        return f64_to_u64_x86_py(kmer / (ent_val + eps))

    # ---- spaced/windowed kmer at start (encoder.h:547-592) -------------
    def kmer_at(self, codes, start: int):
        sp = self.sp
        nv = codes[start]
        self.ent.clear()
        if nv < 0:
            return OVERFLOW
        kmer = int(nv)
        self.ent.push(nv)
        bits = bits_of(self.it)
        radix = radix_of(self.it)
        pos = start
        for off in sp.offsets:
            pos += off
            nv = codes[pos]
            if nv < 0:
                return OVERFLOW
            if bits is not None:
                kmer = ((kmer << bits) | int(nv)) & U64
            else:
                kmer = (kmer * radix + int(nv)) & U64
            self.ent.push(nv)
        return kmer

    # ---- emission streams ----------------------------------------------
    def for_each(self, seq: bytes):
        codes = [self.lut[b] for b in seq]
        sp = self.sp
        out = []
        l = len(seq)
        if l < sp.c:
            return out
        if self.canon:
            if sp.unwindowed():
                for km in self._rolling_valid(codes):
                    out.append(canonical_py(km, sp.k))
            elif self.scheme == "entropy" and sp.unspaced():
                for km in self._uncanon_unspaced_windowed_entropy(codes):
                    out.append(canonical_py(km, sp.k))
            else:
                out.extend(self._canon_windowed(codes))
        else:
            if sp.unspaced():
                if sp.unwindowed():
                    out.extend(self._rolling_valid(codes))
                elif self.scheme == "entropy":
                    out.extend(self._uncanon_unspaced_windowed_entropy(codes))
                else:
                    out.extend(self._uncanon_unspaced_windowed(codes))
            else:
                if sp.unwindowed():
                    for i in range(l - sp.c + 1):
                        km = self.kmer_at(codes, i)
                        if km != OVERFLOW:
                            out.append(km)
                else:
                    out.extend(self._uncanon_spaced_windowed(codes))
        return out

    def _rolling_valid(self, codes):
        """for_each_uncanon_unspaced_unwindowed (encoder.h:241-272)."""
        sp = self.sp
        mask = kmer_mask(self.it, sp.k)
        bits = bits_of(self.it)
        radix = radix_of(self.it)
        kmer, filled, pos, l = 0, 0, 0, len(codes)
        while pos < l:
            while filled < sp.k and pos < l:
                nv = codes[pos]
                pos += 1
                if nv < 0:
                    kmer, filled = 0, 0
                    continue
                kmer = (kmer * radix + int(nv)) & U64
                filled += 1
            if filled == sp.k:
                kmer = kmer & mask if bits is not None else kmer % mask
                yield kmer
                filled -= 1

    def _canon_windowed(self, codes):
        """for_each_canon_windowed via next_canonicalized_minimizer
        (encoder.h:212-217,622-628)."""
        sp = self.sp
        qmap = QMap(sp.window_kmers)
        out = []
        for pos in range(len(codes) - sp.c + 1):
            nk = self.kmer_at(codes, pos)
            nk = canonical_py(nk, sp.k) if self.it == InputType.DNA else nk
            ev = self.ent.value() if self.scheme == "entropy" else None
            sc = self.score(nk, ev, 1e-4)
            mn = qmap.next_value(nk, sc)
            if mn != OVERFLOW:
                out.append(mn)
        return out

    def _uncanon_spaced_windowed(self, codes):
        """for_each_uncanon_spaced via next_minimizer (encoder.h:233-239,
        616-621): N-seeds pushed as OVERFLOW."""
        sp = self.sp
        qmap = QMap(sp.window_kmers)
        out = []
        for pos in range(len(codes) - sp.c + 1):
            nk = self.kmer_at(codes, pos)
            ev = self.ent.value() if self.scheme == "entropy" else None
            sc = self.score(nk, ev, 1e-4)
            mn = qmap.next_value(nk, sc)
            if mn != OVERFLOW:
                out.append(mn)
        return out

    def _uncanon_unspaced_windowed(self, codes):
        """for_each_uncanon_unspaced_windowed (encoder.h:274-306): restart
        on N, window persists; trailing partial emission."""
        sp = self.sp
        mask = kmer_mask(self.it, sp.k)
        bits = bits_of(self.it)
        radix = radix_of(self.it)
        qmap = QMap(sp.window_kmers)
        out = []
        kmer, filled, pos, l = 0, 0, 0, len(codes)
        while pos < l:
            while filled < sp.k and pos < l:
                nv = codes[pos]
                pos += 1
                if nv < 0:
                    kmer, filled = 0, 0
                    continue
                kmer = (kmer * radix + int(nv)) & U64
                filled += 1
            if filled == sp.k:
                kmer = kmer & mask if bits is not None else kmer % mask
                mn = qmap.next_value(kmer, self.score(kmer, None, 1e-4))
                if mn != OVERFLOW:
                    out.append(mn)
                filled -= 1
        if qmap.partially_full():
            out.append(qmap.max_in_queue())
        return out

    def _uncanon_unspaced_windowed_entropy(self, codes):
        """for_each_uncanon_unspaced_windowed_entropy_ (encoder.h:308-346)."""
        sp = self.sp
        mask = kmer_mask(self.it, sp.k)
        bits = bits_of(self.it)
        radix = radix_of(self.it)
        qmap = QMap(sp.window_kmers)
        ent = EntTracker(sp.k)
        out = []
        kmer, filled, pos, l = 0, 0, 0, len(codes)
        ent.clear()
        while pos < l:
            while filled < sp.k and pos < l:
                nv = codes[pos]
                pos += 1
                if nv < 0:
                    kmer, filled = 0, 0
                    ent.clear()
                    continue
                kmer = (kmer * radix + int(nv)) & U64
                ent.push(nv)
                filled += 1
            if filled == sp.k:
                kmer = kmer & mask if bits is not None else kmer % mask
                sc = f64_to_u64_x86_py(kmer / (ent.value() + 1e-3))
                mn = qmap.next_value(kmer, sc)
                if mn != OVERFLOW:
                    out.append(mn)
                filled -= 1
        if qmap.partially_full():
            out.append(qmap.max_in_queue())
        return out
