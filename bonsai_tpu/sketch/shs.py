"""Multi-k k-mer counting and the .shs / .bin dump formats.

Equivalent of kmerc::build_kmer_counts / build_kmer_sets / dump_maps
(/root/reference/include/bonsai/kmer_counter.h:16-133): one pass of a
rolling-hash ladder over the input, per-k u16 saturating count maps,
dumped as gzipped

  .shs:  u64 count | u64 sorted hashes            (kmer_counter.h:94-133)
  .bin:  u64 count | u64 keys | u16 counts

Byte layouts match the reference exactly; key ORDER in .bin differs (we
write sorted keys, the reference writes khash iteration order — content,
not order, is the contract; .shs is sorted in both).

The counting itself is vectorized: the khash insert/increment loop is
replaced by sort + segment-count over the batched hash stream.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.rolling import MultiKRollingEncoder
from ..io import fastx


def _contig_code_batches(path: str, lut, max_chunk: int = 1 << 20, overlap: int = 0):
    """Yield (codes_row, n_valid) int8 arrays per contig chunk with overlap
    context so a k-ladder sees every window exactly once."""
    for _, seq, _ in fastx.read_fastx(path):
        codes = fastx.encode_contig(seq, lut)
        L = codes.size
        if L == 0:
            continue
        if L <= max_chunk:
            yield codes
            continue
        lo = 0
        while lo < L:
            hi = min(lo + max_chunk, L)
            yield codes[max(lo - overlap, 0) : hi]
            lo = hi


def count_hashes(hashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """sorted unique hashes + u16 saturating counts (khash_t(i16) analog)."""
    if hashes.size == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint16))
    s = np.sort(hashes)
    uniq_mask = np.ones(s.size, dtype=bool)
    uniq_mask[1:] = s[1:] != s[:-1]
    keys = s[uniq_mask]
    counts = np.diff(np.append(np.nonzero(uniq_mask)[0], s.size))
    return keys, np.minimum(counts, 0xFFFF).astype(np.uint16)


class MultiKCounter:
    """One-pass multi-k counter over files (RollingHasherSet analog)."""

    def __init__(self, ks: Sequence[int], canon: bool = False,
                 seedseed: int = 1337, lut=None, nthash: bool = False):
        from ..core.alphabet import DNA4

        self.ks = list(ks)
        self.enc = MultiKRollingEncoder(self.ks, canon=canon,
                                        seedseed=seedseed, nthash=nthash)
        self.lut = DNA4.lut if lut is None else lut
        self._hash_chunks: List[List[np.ndarray]] = [[] for _ in self.ks]

    def add_file(self, path: str):
        maxk = max(self.ks)
        for codes in _contig_code_batches(path, self.lut, overlap=maxk - 1):
            if codes.size < maxk:
                # still emit for the k's that fit
                pass
            row = codes[None, :]
            lengths = np.array([codes.size], dtype=np.int32)
            for ki, (vals, valid) in enumerate(self.enc.hashes(row, lengths)):
                v = np.asarray(vals)[np.asarray(valid)]
                if v.size:
                    self._hash_chunks[ki].append(v)

    def counts(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(sorted unique hashes, u16 counts)] per k."""
        out = []
        for chunks in self._hash_chunks:
            h = (
                np.concatenate(chunks)
                if chunks
                else np.empty(0, np.uint64)
            )
            out.append(count_hashes(h))
        return out

    def sets(self) -> List[np.ndarray]:
        """[sorted unique hashes] per k (build_kmer_sets analog)."""
        return [k for k, _ in self.counts()]


# -- dump formats (byte-compatible with kmer_counter.h) ---------------------
def write_shs(path: str, hashes_sorted: np.ndarray):
    with gzip.open(path, "wb") as fh:
        fh.write(np.uint64(hashes_sorted.size).tobytes())
        fh.write(np.ascontiguousarray(hashes_sorted, dtype=np.uint64).tobytes())


def read_shs(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as fh:
        (n,) = np.frombuffer(fh.read(8), dtype=np.uint64)
        return np.frombuffer(fh.read(int(n) * 8), dtype=np.uint64).copy()


def write_bin(path: str, keys: np.ndarray, counts: np.ndarray):
    with gzip.open(path, "wb") as fh:
        fh.write(np.uint64(keys.size).tobytes())
        fh.write(np.ascontiguousarray(keys, dtype=np.uint64).tobytes())
        fh.write(np.ascontiguousarray(counts, dtype=np.uint16).tobytes())


def read_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with gzip.open(path, "rb") as fh:
        (n,) = np.frombuffer(fh.read(8), dtype=np.uint64)
        n = int(n)
        keys = np.frombuffer(fh.read(n * 8), dtype=np.uint64).copy()
        counts = np.frombuffer(fh.read(n * 2), dtype=np.uint16).copy()
        return keys, counts


WRITE_SHS = 1
WRITE_KVMAP = 2


def dump_maps(prefix: str, ks: Sequence[int], path: str, canon: bool = False,
              flag: int = WRITE_SHS | WRITE_KVMAP, lut=None,
              nthash: bool = False) -> List[str]:
    """Count k-mers of `path` for each k and dump  <prefix>.<k>.shs /
    <prefix>.<k>.bin  (dump_maps, kmer_counter.h:94-133; nthash selects the
    reference's -htype 2 NTC64 backend).  Returns the written file names."""
    ctr = MultiKCounter(ks, canon=canon, lut=lut, nthash=nthash)
    ctr.add_file(path)
    written = []
    for k, (keys, counts) in zip(ks, ctr.counts()):
        if flag & WRITE_KVMAP:
            fn = f"{prefix}.{k}.bin"
            write_bin(fn, keys, counts)
            written.append(fn)
        if flag & WRITE_SHS:
            fn = f"{prefix}.{k}.shs"
            write_shs(fn, keys)
            written.append(fn)
    return written
