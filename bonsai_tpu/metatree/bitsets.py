"""Per-taxon k-mer sets, kmer x taxon bit matrices, and subset compares.

Equivalents of kgset_t (/root/reference/include/bonsai/kgset.h:48-124),
bitmap_t / AdjacencyList / score_node_addn (bitmap.h:8-150), and veccmp
(bitcmp.h:18-65).

Vectorized design: the khash-set-per-genome + per-kmer bitvector hashmap
becomes
  * per-taxon sorted unique kmer arrays (device encode + sort),
  * one merged (kmer, taxon) sort -> a packed-u64 bit matrix
    (n_kmers, ceil(T/64)),
  * unique bit PATTERNS with multiplicities via lexicographic row sort,
  * all-pairs subset classification as vectorized bitwise reductions
    ((P, P, W) AND/ANDN + any-reduce) instead of scalar AVX2 testz loops.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.spacer import Spacer
from ..db import build as build_mod
from ..taxonomy.tree import TaxTree


class BitCmp(IntEnum):
    """bitcmp.h:7-12 (values match the reference enum)."""

    EQUAL = 0
    FIRST_PARENT = 1
    SECOND_PARENT = 2
    INCOMPARABLE = 3


_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def vec_popcnt(rows: np.ndarray) -> np.ndarray:
    """Popcount of packed-u64 rows (pop::vec_popcnt)."""
    b = rows.view(np.uint8)
    return _POP8[b].reshape(rows.shape[0], -1).sum(axis=1)


def veccmp(a: np.ndarray, b: np.ndarray) -> BitCmp:
    """Subset-compare two packed bitvectors (bitcmp.h:18-65)."""
    a_sub_b = not np.any(a & ~b)  # a's bits all in b  -> b could be parent
    b_sub_a = not np.any(b & ~a)
    if a_sub_b and b_sub_a:
        return BitCmp.EQUAL
    if b_sub_a:
        return BitCmp.FIRST_PARENT  # a is a strict parent of b
    if a_sub_b:
        return BitCmp.SECOND_PARENT
    return BitCmp.INCOMPARABLE


def pairwise_veccmp(patterns: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs subset classification of (P, W) packed rows.

    Returns boolean (P, P) matrices (i_superset_j, i_subset_j), both
    including equality; strict relations are the and-nots."""
    a = patterns[:, None, :]
    b = patterns[None, :, :]
    i_superset_j = ~np.any(b & ~a, axis=-1)
    i_subset_j = ~np.any(a & ~b, axis=-1)
    return i_superset_j, i_subset_j


class KmerGenomeSets:
    """kgset_t: per-taxon (or per-path) canonical-minimizer sets.

    kgset.h's kt_forpool over genomes becomes a loop of device-encoded
    genome passes (the per-genome encode is the same batched kernel the DB
    build uses)."""

    def __init__(
        self,
        tax_to_paths: Dict[int, List[str]],
        sp: Spacer,
        canonicalize: bool = True,
        acceptable: Optional[np.ndarray] = None,  # sorted u64 filter set
        scheme: str = "lex",
    ):
        self.taxes: List[int] = []
        self.sets: List[np.ndarray] = []
        for tax, paths in tax_to_paths.items():
            per = []
            for p in paths:
                per.append(
                    build_mod.genome_kmer_set(p, sp, canonicalize, scheme)
                )
            s = (
                np.unique(np.concatenate(per))
                if per
                else np.empty(0, np.uint64)
            )
            if acceptable is not None and s.size:
                idx = np.searchsorted(acceptable, s)
                idx = np.minimum(idx, acceptable.size - 1)
                s = s[acceptable[idx] == s] if acceptable.size else s[:0]
            self.taxes.append(int(tax))
            self.sets.append(s)

    def size(self) -> int:
        return len(self.sets)

    def weight(self) -> int:
        """Total kmers across sets (kgset.h:114-120)."""
        return int(sum(s.size for s in self.sets))


def bitmap_patterns(
    kgs: KmerGenomeSets, drop_trivial: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """kmer x taxon presence -> unique packed bit patterns + counts.

    bitmap_t::fill + to_counter (bitmap.h:74-138): build the per-kmer
    bitvector over the T sets, drop kmers present in exactly 1 or all T
    sets (compressed by the existing taxonomy), and count identical
    patterns.  Returns (patterns (P, W) u64, counts (P,))."""
    T = kgs.size()
    W = max((T + 63) >> 6, 1)
    if T == 0:
        return np.empty((0, W), np.uint64), np.empty(0, np.int64)
    kmers = np.concatenate(kgs.sets)
    owners = np.concatenate(
        [np.full(s.size, i, dtype=np.int64) for i, s in enumerate(kgs.sets)]
    )
    order = np.argsort(kmers, kind="stable")
    kmers, owners = kmers[order], owners[order]
    # segment boundaries per distinct kmer
    first = np.ones(kmers.size, dtype=bool)
    first[1:] = kmers[1:] != kmers[:-1]
    row_of = np.cumsum(first) - 1
    n_rows = int(row_of[-1]) + 1 if kmers.size else 0
    rows = np.zeros((n_rows, W), dtype=np.uint64)
    np.bitwise_or.at(
        rows,
        (row_of, owners >> 6),
        np.uint64(1) << (owners & 63).astype(np.uint64),
    )
    if drop_trivial:
        pc = vec_popcnt(rows)
        rows = rows[(pc != 1) & (pc != T)]
    if rows.size == 0:
        return np.empty((0, W), np.uint64), np.empty(0, np.int64)
    # unique patterns + counts via lexicographic row sort
    keys = tuple(rows[:, w] for w in range(W - 1, -1, -1))
    order = np.lexsort(keys)
    rows = rows[order]
    firstp = np.ones(rows.shape[0], dtype=bool)
    firstp[1:] = np.any(rows[1:] != rows[:-1], axis=1)
    patterns = rows[firstp]
    counts = np.diff(np.append(np.nonzero(firstp)[0], rows.shape[0]))
    return patterns, counts.astype(np.int64)


def adjacency(
    patterns: np.ndarray, reverse: bool = False
) -> List[np.ndarray]:
    """AdjacencyList (bitmap.h:8-66): adj[i] = indices j where pattern i is
    a STRICT parent (superset) of pattern j (children if reverse)."""
    sup, sub = pairwise_veccmp(patterns)
    strict_parent = sup & ~sub  # superset and not equal
    if reverse:
        strict_parent = strict_parent.T
    np.fill_diagonal(strict_parent, False)
    return [np.nonzero(strict_parent[i])[0] for i in range(patterns.shape[0])]


def score_node_addn(
    i: int,
    adj: List[np.ndarray],
    patterns: np.ndarray,
    counts: np.ndarray,
    nelem: int,
) -> int:
    """score_node_addn (bitmap.h:141-150): count_i * (nelem - pc_i) +
    sum over strict children j of count_j * pc_j."""
    pc = vec_popcnt(patterns)
    ret = int(counts[i]) * (nelem - int(pc[i]))
    for j in adj[i]:
        ret += int(counts[j]) * int(pc[j])
    return ret
