"""Batched encoder facade: reference-equivalent k-mer/minimizer streams.

This is the vectorized counterpart of ``Encoder<ScoreType, KmerT>::for_each``
(/root/reference/include/bonsai/encoder.h:113-638).  Where the reference
walks one sequence with a scalar rolling loop and a btree window, this class
maps a whole (B, L) batch of code arrays to an emission matrix in one traced
computation: pack -> score -> sliding-min -> mask.

Emission disciplines per reference dispatch (encoder.h:416-442):

  canonical, unwindowed : rolling encode, drop N-windows, canonicalize
  canonical, windowed   : every position pushed; N-window ->
                          canonical(OVERFLOW) == 0; minimize (score, kmer)
  canonical, windowed, entropy, unspaced:
                          uncanonical windowed-entropy machinery, then
                          canonicalize the *emitted* minimizers
  uncanonical, unspaced, unwindowed : rolling encode, drop N-windows
  uncanonical, unspaced, windowed   : valid seeds only; window slides over
                          the valid subsequence + one trailing partial-window
                          emission
  uncanonical, spaced   : every position pushed with OVERFLOW for N-seeds;
                          emissions equal to OVERFLOW are dropped

Spaced seeds force canonicalize off (encoder.h:148-150); non-DNA input types
force canonicalize off (encoder.h:419).

Scoring schemes: lex (FRev64 bit-mix), entropy (kmer / (H+eps)), hash
(phase-1 map lookup).  Note: the reference's hash_score (encoder.h:61-74)
has an inverted branch and returns the value at slot 0 for present keys,
degenerating TAX_DEPTH/FEATURE_COUNT minimization to raw-kmer ordering; we
implement the documented intent (lookup of the phase-1 score) instead.

The reference has TWO distinct entropy disciplines:

* scheme "entropy" — the fused string-overload machinery
  (for_each_*_unspaced_windowed_entropy_, encoder.h:308-346): uncanonical
  selection with eps .001, canonicalize the emitted winners, restart on N.
* scheme "entropy-file" — what `bonsai build -e` actually runs: the FILE
  overload dispatches on windowed-ness only (for_each_canon(ks),
  encoder.h:448-451), so entropy scoring happens in the generic windowed
  loops via score::Entropy/ent_score with eps 1e-4: canonical path scores
  the CANONICAL kmer against the gathered-window entropy (kmer() feeds the
  tracker, encoder.h:557-575); the uncanonical rolling path never feeds the
  tracker, so its H is pinned at NOT_FULL == -1.
Both convert the double score to u64 with the pre-AVX512 x86 semantics
(entropy.f64_to_u64_x86; the oracle is built -march=x86-64-v3 to pin this).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from . import encode, entropy, hashes, minimize
from .alphabet import InputType, alphabet_of, radix_of
from .spacer import Spacer

U64_MAX = (1 << 64) - 1


def _xp(x):
    if type(x).__module__.startswith("jax") or hasattr(x, "aval"):
        import jax.numpy as jnp

        return jnp
    return np


class Emissions(NamedTuple):
    """Per-read emitted values; only entries with mask True are real.

    Emission order within a row is left-to-right seed order (matching the
    reference's per-sequence functor call order); a trailing partial-window
    minimizer, when present, occupies the first masked-in slot after the
    windowed emissions (reference emits it last)."""

    values: object  # (B, E) uint64
    mask: object  # (B, E) bool


class BatchEncoder:
    def __init__(
        self,
        spacer: Spacer,
        canonicalize: bool = True,
        scheme: str = "lex",
        input_type: InputType = InputType.DNA,
        score_map: Optional[object] = None,
    ):
        if scheme not in ("lex", "entropy", "entropy-file", "hash"):
            raise ValueError(f"unknown scheme {scheme}")
        self.sp = spacer
        self.it = InputType(input_type)
        self.scheme = scheme
        self.score_map = score_map
        # ctor semantics: spaced seeds cannot canonicalize (encoder.h:148-150)
        # and only DNA supports reverse complement (encoder.h:419).
        self.canon = bool(canonicalize) and spacer.unspaced() and self.it == InputType.DNA

    # -- scoring ----------------------------------------------------------
    def _scores(self, kmers, codes=None, eps=None):
        if self.scheme == "lex":
            return hashes.frev64(kmers)
        if self.scheme == "hash":
            if self.score_map is None:
                raise ValueError("hash scheme requires a score_map")
            return self.score_map.lookup_scores(kmers)
        if self.scheme == "entropy-file":
            # The FILE-overload entropy paths all see ent.value() == NOT_FULL
            # == -1: kmer()'s gather seeds the first char without pushing it
            # (encoder.h:551 vs :563), so the k-char tracker holds k-1 chars,
            # and the rolling uncanonical loop never pushes at all
            # (encoder.h:274-306).  `bonsai build -e` therefore scores every
            # seed as kmer / (-1 + 1e-4) — max-kmer selection; reproduced
            # bit-exactly (conversion semantics in entropy.f64_to_u64_x86).
            return entropy.entropy_scores(kmers, -1.0, 1e-4)
        # entropy (fused string-overload path: real windowed entropy)
        xp = _xp(kmers)
        sp = self.sp
        n_codes = radix_of(self.it)
        if sp.unspaced():
            counts = entropy.window_code_counts(codes, sp.k, n_codes)
        else:
            counts = entropy.spaced_code_counts(codes, sp.positions, n_codes)
        H = entropy.entropy_value(counts, sp.k)
        return entropy.entropy_scores(kmers, H, eps)

    # -- main entry -------------------------------------------------------
    def emissions(self, codes, lengths) -> Emissions:
        """codes: (B, L) int8 (pad with -1); lengths: (B,) int32."""
        xp = _xp(codes)
        sp = self.sp
        it = self.it
        span = sp.c
        if codes.shape[-1] < span:
            B = codes.shape[0]
            z = xp.zeros((B, 0), dtype=xp.uint64)
            return Emissions(z, xp.zeros((B, 0), dtype=bool))

        if sp.unspaced():
            kmers, invalid = encode.pack_kmers(codes, sp.k, it)
        else:
            kmers, invalid = encode.pack_spaced_kmers(codes, sp.offsets, it)
        kmers = encode.apply_mask(kmers, sp.k, it)
        P = kmers.shape[-1]
        inbounds = encode.position_validity(lengths, P, span)
        valid = inbounds & ~invalid
        n_push_all = xp.maximum(lengths - (span - 1), 0).astype(xp.int32)

        if sp.unwindowed():
            out = encode.canonicalize(kmers, sp.k) if self.canon else kmers
            return Emissions(out, valid)

        W = sp.window_kmers
        if self.canon and self.scheme == "entropy" and sp.unspaced():
            # entropy path: select on uncanonical kmers, canonicalize after
            em = self._windowed_compacted(kmers, invalid, valid, codes, eps=1e-3)
            vals = encode.canonicalize(em.values, sp.k)
            return Emissions(xp.where(em.mask, vals, em.values), em.mask)
        if (not self.canon) and self.scheme == "entropy-file" and sp.unspaced():
            # file-overload entropy, uncanonical (for_each_uncanon_unspaced_
            # windowed, encoder.h:274-306): the rolling loop never feeds the
            # entropy tracker, so ent.value() is always NOT_FULL == -1 and
            # the score degenerates to u64(kmer / (-1 + 1e-4)) — effectively
            # max-kmer selection.  Reproduced exactly.
            scores = entropy.entropy_scores(kmers, -1.0, 1e-4)
            out_k, out_v, tail_k, tail_v = minimize.compacted_minimizers(
                scores, kmers, valid, W
            )
            values = xp.concatenate([tail_k[:, None], out_k], axis=-1)
            mask = xp.concatenate([tail_v[:, None], out_v], axis=-1)
            return Emissions(values, mask)
        if self.canon:
            # in-read N positions push canonical(OVERFLOW) == 0; pad tail is
            # masked out via n_push so its values are irrelevant
            ck = xp.where(invalid, xp.uint64(0), encode.canonicalize(kmers, sp.k))
            scores = self._scores(ck, codes, eps=1e-4)
            if P < W:
                B = codes.shape[0]
                z = xp.zeros((B, 0), dtype=xp.uint64)
                return Emissions(z, xp.zeros((B, 0), dtype=bool))
            out_k, out_v = minimize.positional_minimizers(scores, ck, W, n_push_all)
            return Emissions(out_k, out_v)
        if sp.unspaced():
            if self.scheme == "entropy":
                return self._windowed_compacted(kmers, invalid, valid, codes, eps=1e-3)
            return self._windowed_compacted(kmers, invalid, valid, codes, eps=None)
        # spaced windowed: every position pushed, N-seeds as OVERFLOW
        ov = xp.where(invalid, xp.uint64(U64_MAX), kmers)
        if self.scheme in ("entropy", "entropy-file"):
            # invalid seeds have a partially-filled tracker -> NOT_FULL,
            # whose quotient is out of i64 range -> 0x8000...0 (see entropy.py)
            s_valid = self._scores(ov, codes, eps=1e-4)
            scores = xp.where(invalid, xp.uint64(entropy.INT64_MIN_U), s_valid)
        else:
            scores = self._scores(ov, codes, eps=1e-4)
        if P < W:
            B = codes.shape[0]
            z = xp.zeros((B, 0), dtype=xp.uint64)
            return Emissions(z, xp.zeros((B, 0), dtype=bool))
        out_k, out_v = minimize.positional_minimizers(scores, ov, W, n_push_all)
        out_v = out_v & (out_k != xp.uint64(U64_MAX))
        return Emissions(out_k, out_v)

    def _windowed_compacted(self, kmers, invalid, valid, codes, eps) -> Emissions:
        xp = _xp(kmers)
        W = self.sp.window_kmers
        scores = self._scores(kmers, codes, eps=eps if eps is not None else 1e-4)
        out_k, out_v, tail_k, tail_v = minimize.compacted_minimizers(
            scores, kmers, valid, W
        )
        # append the trailing partial-window emission in the slot right after
        # the last windowed emission (position n_valid - W + 1 == 0 when the
        # tail fires, since tail fires only when n_valid < W).
        tail_col_k = tail_k[:, None]
        tail_col_v = tail_v[:, None]
        values = xp.concatenate([tail_col_k, out_k], axis=-1)
        mask = xp.concatenate([tail_col_v, out_v], axis=-1)
        return Emissions(values, mask)

    # -- set-style convenience (host) -------------------------------------
    def emitted_set(self, codes, lengths) -> np.ndarray:
        """Distinct emitted values of a batch (host numpy, sorted)."""
        em = self.emissions(codes, lengths)
        vals = np.asarray(em.values)[np.asarray(em.mask)]
        return np.unique(vals)
