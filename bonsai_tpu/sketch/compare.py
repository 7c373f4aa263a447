"""Exact set comparison over sorted hash arrays.

Equivalent of setcmp.h (intersection_size / jaccard_index / union_size over
khash sets, /root/reference/include/bonsai/setcmp.h:10-34) and the cmpshs
tool (pairwise comparison of .shs dumps, /root/reference/bin/cmpshs.cpp).
khash membership loops become sorted-array intersections (searchsorted) —
the vector-native formulation."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def intersection_size(a: np.ndarray, b: np.ndarray) -> int:
    """|A n B| for sorted unique u64 arrays."""
    if a.size > b.size:
        a, b = b, a
    if a.size == 0:
        return 0
    idx = np.searchsorted(b, a)
    idx = np.minimum(idx, b.size - 1)
    return int((b[idx] == a).sum())


def union_size(a: np.ndarray, b: np.ndarray) -> int:
    return int(a.size + b.size - intersection_size(a, b))


def jaccard_index(a: np.ndarray, b: np.ndarray) -> float:
    i = intersection_size(a, b)
    u = a.size + b.size - i
    return i / u if u else 0.0


def containment(a: np.ndarray, b: np.ndarray) -> float:
    """|A n B| / |A|."""
    return intersection_size(a, b) / a.size if a.size else 0.0


def pairwise_matrix(
    sets: Sequence[np.ndarray], metric: str = "jaccard"
) -> np.ndarray:
    """Dense pairwise comparison (the cmpshs output)."""
    n = len(sets)
    out = np.zeros((n, n), dtype=np.float64)
    fn = {
        "jaccard": jaccard_index,
        "intersection": lambda a, b: float(intersection_size(a, b)),
        "union": lambda a, b: float(union_size(a, b)),
        "containment": containment,
    }[metric]
    for i in range(n):
        out[i, i] = fn(sets[i], sets[i])
        for j in range(i + 1, n):
            v = fn(sets[i], sets[j])
            out[i, j] = v
            out[j, i] = (
                v if metric != "containment" else fn(sets[j], sets[i])
            )
    return out


class Counter:
    """Hash multiset with histogram printing (count::Counter<T>,
    /root/reference/include/bonsai/counter.h:76+)."""

    def __init__(self):
        self._keys = np.empty(0, dtype=np.uint64)
        self._counts = np.empty(0, dtype=np.int64)

    def add(self, values: np.ndarray):
        v = np.asarray(values, dtype=np.uint64).ravel()
        keys = np.concatenate([np.repeat(self._keys, 1), v])
        counts = np.concatenate(
            [self._counts, np.ones(v.size, dtype=np.int64)]
        )
        order = np.argsort(keys, kind="stable")
        keys, counts = keys[order], counts[order]
        uniq = np.ones(keys.size, dtype=bool)
        uniq[1:] = keys[1:] != keys[:-1]
        seg = np.cumsum(uniq) - 1
        agg = np.zeros(int(seg[-1]) + 1 if keys.size else 0, dtype=np.int64)
        np.add.at(agg, seg, counts)
        self._keys = keys[uniq]
        self._counts = agg

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._keys, self._counts

    def histogram(self) -> Tuple[np.ndarray, np.ndarray]:
        """count-of-counts: (multiplicity, #keys with it), ascending."""
        u, c = np.unique(self._counts, return_counts=True)
        return u, c

    def print_hist(self, fh):
        fh.write("#Count\tNumber of occurrences\n")
        for mult, n in zip(*self.histogram()):
            fh.write(f"{mult}\t{n}\n")
