"""Database construction pipelines.

Vectorized re-design of the reference build farm
(/root/reference/include/bonsai/feature_min.h:93-281): where the reference
runs an async thread farm of per-genome khash fills folded into a global map
under CAS, here each genome streams through the batched device encoder into
a sorted distinct-minimizer set, and the global merge is a *deterministic*
sort + segment-fold — LCA is associative and commutative, so no locks, no
CAS, and bit-reproducible output regardless of scheduling.

Value packings (feature_min.h:10-20):
  tax-depth : ((~0 - depth) << 32) | taxid   (deeper = smaller = "better")
  feature ct: (count << 32) | taxid

Note two reference bugs implemented here as *intended* rather than as coded:
update_td_map's initial insert reads a value from the wrong table
(feature_min.h:241) and update_feature_counter stores node_depth in the
taxid field and never increments the count (feature_min.h:261-262); we store
TDencode(depth(taxid), taxid) and (count, lca) respectively.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.alphabet import InputType, alphabet_of
from ..core.encoder import BatchEncoder
from ..core.spacer import Spacer
from ..io import fastx
from ..taxonomy.ncbi import parse_nameid_map, taxid_for_path
from ..taxonomy.tree import TaxTree
from .table import KmerTable, ScoreMap

TAX_T_MAX = 0xFFFFFFFF


def TDencode(depth, taxid):
    return ((TAX_T_MAX - np.asarray(depth, dtype=np.uint64)) << np.uint64(32)) | np.asarray(
        taxid, dtype=np.uint64
    )


def TDdepth(v):
    return TAX_T_MAX - (np.asarray(v, dtype=np.uint64) >> np.uint64(32)).astype(np.uint32)


def TDtax(v):
    return (np.asarray(v, dtype=np.uint64) & np.uint64(TAX_T_MAX)).astype(np.uint32)


def FMencode(count, taxid):
    return (np.asarray(count, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        taxid, dtype=np.uint64
    )


def FMcount(v):
    return (np.asarray(v, dtype=np.uint64) >> np.uint64(32)).astype(np.uint32)


def FMtax(v):
    return (np.asarray(v, dtype=np.uint64) & np.uint64(TAX_T_MAX)).astype(np.uint32)


# -- per-genome minimizer sets ------------------------------------------------

def genome_kmer_set(
    path: str,
    sp: Spacer,
    canonicalize: bool = True,
    scheme: str = "lex",
    input_type: InputType = InputType.DNA,
    score_map=None,
    use_device: bool = False,
    block: int = 1 << 22,
) -> np.ndarray:
    """Distinct emitted minimizers of one genome (sorted uint64).

    Equivalent of fill_set_genome (feature_min.h:67-82).  Contigs are
    encoded whole when they fit in ``block`` bases; longer contigs are
    processed in halo-overlapped chunks (halo w-1 bases) — exact for every
    discipline except the uncanonical windowed+N trailing edge, which only
    applies at true contig ends and is handled there.
    """
    enc = BatchEncoder(sp, canonicalize, scheme, input_type, score_map)
    lut = alphabet_of(InputType(input_type)).lut
    native = _native_kmer_fn(sp, enc, input_type, use_device)
    pieces: List[np.ndarray] = []
    for _, seq, _ in fastx.read_fastx(path):
        if len(seq) < sp.c:
            continue
        if native is not None:
            # raw (non-deduped) kmers per contig; one unique at the end
            pieces.append(native(seq, lut, sp.k, enc.canon))
        else:
            pieces.extend(_contig_sets(enc, seq, lut, sp, block, use_device))
    if not pieces:
        return np.zeros(0, dtype=np.uint64)
    return unique_u64(np.concatenate(pieces))


def _native_kmer_fn(sp, enc, input_type, use_device):
    """One-pass C extraction for the (DNA, contiguous, unwindowed) hot
    discipline (bit-identical to BatchEncoder; see native/src/kmers.cpp)."""
    if use_device or not (
        sp.unspaced() and sp.unwindowed()
        and InputType(input_type) == InputType.DNA and sp.k <= 32
    ):
        return None
    from ..native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "btpu_canon_kmer_set"):
        return None

    def run(seq: bytes, lut, k: int, canonical: bool) -> np.ndarray:
        buf = np.frombuffer(seq, dtype=np.uint8)
        out = np.empty(len(seq), dtype=np.uint64)
        lut8 = np.ascontiguousarray(lut, dtype=np.int8)
        m = lib.btpu_canon_kmer_set(
            buf.ctypes.data, len(seq), lut8.ctypes.data, k,
            1 if canonical else 0, out.ctypes.data,
        )
        if m < 0:
            raise ValueError("btpu_canon_kmer_set failed")
        return out[:m].copy()

    return run


def _contig_sets(enc, seq, lut, sp, block, use_device):
    out = []
    halo = sp.w - 1
    n = len(seq)
    step = block
    start = 0
    while start < n:
        end = min(start + step + halo, n)
        sub = seq[start:end]
        is_last = end >= n
        codes = fastx.encode_contig(sub, lut)[None, :]
        lengths = np.array([len(sub)], dtype=np.int32)
        if use_device:
            import jax.numpy as jnp

            em = enc.emissions(jnp.asarray(codes), jnp.asarray(lengths))
            vals = np.asarray(em.values)
            mask = np.asarray(em.mask)
        else:
            em = enc.emissions(codes, lengths)
            vals, mask = np.asarray(em.values), np.asarray(em.mask)
        if not is_last and sp.w > sp.c and not enc.canon:
            # windowed uncanon: drop the trailing partial emission of a
            # non-final chunk (it is not a real contig end) — slot 0 by
            # construction (see BatchEncoder._windowed_compacted).  Only
            # W = w-c+1 > 1 windows have a partial trailing window; a
            # spaced seed with w == c fills its 1-wide window at every
            # position, so its slot 0 is a REAL emission (QueueMap(1)
            # semantics, qmap.h:80-87).
            mask = mask.copy()
            mask[:, 0] = False
        out.append(np.unique(vals[mask]))
        if is_last:
            break
        start += step
    return out


# -- LCA segment-fold ---------------------------------------------------------

def _native_lib():
    from ..native import get_lib

    return get_lib()


def _sort_pairs_by_key(keys: np.ndarray, taxa: np.ndarray):
    """(keys, taxa) sorted by key — native LSD radix (sortops.cpp) when
    available, np.argsort otherwise.  LCA folding is order-independent
    within a key group, so stability is not required."""
    lib = _native_lib()
    if lib is not None and hasattr(lib, "btpu_radix_sort_kv"):
        k = np.array(keys, dtype=np.uint64, copy=True)
        t = np.array(taxa, dtype=np.uint32, copy=True)
        lib.btpu_radix_sort_kv(k.ctypes.data, t.ctypes.data, k.size)
        return k, t
    order = np.argsort(keys, kind="stable")
    return keys[order], taxa[order].astype(np.uint32)


def unique_u64(arr: np.ndarray) -> np.ndarray:
    """Sorted distinct values of a u64 array (native radix sort-dedup when
    available; np.unique otherwise)."""
    lib = _native_lib()
    if lib is not None and hasattr(lib, "btpu_sort_dedup_u64") and arr.size:
        a = np.array(arr, dtype=np.uint64, copy=True)
        m = lib.btpu_sort_dedup_u64(a.ctypes.data, a.size)
        return a[:m].copy()
    return np.unique(np.asarray(arr, dtype=np.uint64))


def _fold_stats_to_taxa(tree: TaxTree, tmin, tmax, n_miss, n_nz, mmin, mmax):
    """Group stats -> folded taxids (the tail of lca_fold_pairs, shared
    with the native merge path).  tmin/tmax are Euler tin extrema of the
    present members (BIG / -2 when none)."""
    n = tree.tin.shape[0]
    node_of_tin = np.zeros(int(tree.tin.max()) + 2, dtype=np.int32)
    node_of_tin[tree.tin[1:]] = np.arange(1, n, dtype=np.int32)
    has_pres = tmax >= 0
    a = node_of_tin[np.where(has_pres, tmin, 0)]
    b = node_of_tin[np.where(has_pres, tmax, 0)]
    # the distinct (a, b) domain is tiny (bounded by the input taxa
    # domain): presence-mask + rank table instead of np.unique /
    # searchsorted over the full M-sized arrays
    pres_mask = np.zeros(n, dtype=bool)
    pres_mask[a] = True
    pres_mask[b] = True
    dom = np.flatnonzero(pres_mask)
    if dom.size <= 1024:
        rank = np.cumsum(pres_mask, dtype=np.int32) - 1
        ai = rank[a]
        bi = rank[b]
        la, lb = np.meshgrid(dom, dom, indexing="ij")
        lca_tab = tree._lca_compact(
            la.ravel().astype(np.int32), lb.ravel().astype(np.int32)
        ).reshape(dom.size, dom.size)
        r = lca_tab[ai, bi]
    else:
        r = tree._lca_compact(a, b)
    orig = np.zeros(n, dtype=np.uint32)
    orig[1:] = tree.tax_ids
    out = orig[r]
    out = np.where(has_pres & (r == 0), np.uint32(1), out)  # disjoint roots
    if n_miss.any():
        all_same_missing = (~has_pres) & (n_miss > 0) & (mmin == mmax)
        out = np.where(
            (n_miss > 0) & ~all_same_missing, np.uint32(0xFFFFFFFF), out
        )
        out = np.where(all_same_missing, mmin, out)
    if not n_nz.all():
        out = np.where(n_nz == 0, np.uint32(0), out)
    return out


def lca_fold_runs(acc_keys: np.ndarray, acc_taxa: np.ndarray,
                  runs, tree: TaxTree, want_counts: bool = False):
    """LCA-fold of sorted-unique runs without materializing + sorting the
    concatenation: a native k-way merge (sortops.cpp
    btpu_merge_fold_stats) emits per-unique-key group stats in one linear
    pass; the host maps the (tiny-domain) tin extrema through an LCA
    table.  Semantics identical to lca_fold_pairs on the concatenation.

    acc_keys/acc_taxa: the accumulated fold state (sorted unique, may be
    empty).  runs: [(kset_sorted_unique u64, taxid int)].  Returns
    (keys, taxa[, counts]) with counts = group multiplicity (the ftct
    genome count) when want_counts."""
    import ctypes as C

    lib = _native_lib()
    if lib is None or not hasattr(lib, "btpu_merge_fold_stats"):
        keys = np.concatenate(
            [acc_keys] + [k for k, _ in runs]
        ) if runs or acc_keys.size else np.zeros(0, np.uint64)
        taxa = np.concatenate(
            [acc_taxa]
            + [np.full(len(k), t, dtype=np.uint32) for k, t in runs]
        ) if runs or acc_keys.size else np.zeros(0, np.uint32)
        uk, ut = lca_fold_pairs(keys, taxa, tree)
        if not want_counts:
            return uk, ut
        if keys.size:
            cu, counts = np.unique(keys, return_counts=True)
        else:
            cu, counts = keys, np.zeros(0, np.int64)
        return uk, ut, counts
    n = tree.tin.shape[0]
    BIG = np.int32(2 * n + 4)
    key_arrs = []
    tin_arrs = []   # per-element tins or None
    tval_arrs = []  # per-element taxa or None
    tin_consts = []
    tval_consts = []
    if acc_keys.size:
        t = np.ascontiguousarray(acc_taxa, dtype=np.uint32)
        ut = np.unique(t)
        cu = tree.compact(ut, missing_ok=True)
        tin_u = np.where(cu != 0, tree.tin[cu], BIG).astype(np.int32)
        tins = np.ascontiguousarray(tin_u[np.searchsorted(ut, t)])
        key_arrs.append(np.ascontiguousarray(acc_keys, dtype=np.uint64))
        tin_arrs.append(tins)
        tval_arrs.append(t)
        tin_consts.append(0)
        tval_consts.append(0)
    for kset, taxid in runs:
        if not len(kset):
            continue
        cix = int(tree.compact(
            np.array([taxid], dtype=np.uint32), missing_ok=True
        )[0])
        tin_c = int(tree.tin[cix]) if cix != 0 else int(BIG)
        key_arrs.append(np.ascontiguousarray(kset, dtype=np.uint64))
        tin_arrs.append(None)
        tval_arrs.append(None)
        tin_consts.append(tin_c)
        tval_consts.append(int(taxid) & 0xFFFFFFFF)
    G = len(key_arrs)
    if G == 0:
        empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint32))
        return empty + ((np.zeros(0, np.int64),) if want_counts else ())
    N = sum(a.size for a in key_arrs)
    out_keys = np.empty(N, dtype=np.uint64)
    tmin = np.empty(N, dtype=np.int32)
    tmax = np.empty(N, dtype=np.int32)
    nmiss = np.empty(N, dtype=np.uint32)
    nnz = np.empty(N, dtype=np.uint32)
    mmin = np.empty(N, dtype=np.uint32)
    mmax = np.empty(N, dtype=np.uint32)
    count = np.empty(N, dtype=np.uint32)
    kp = (C.c_void_p * G)(*[a.ctypes.data for a in key_arrs])
    lens = np.array([a.size for a in key_arrs], dtype=np.int64)
    tp = (C.c_void_p * G)(
        *[None if a is None else a.ctypes.data for a in tin_arrs]
    )
    vp = (C.c_void_p * G)(
        *[None if a is None else a.ctypes.data for a in tval_arrs]
    )
    tic = np.array(tin_consts, dtype=np.int32)
    tvc = np.array(tval_consts, dtype=np.uint32)
    m = lib.btpu_merge_fold_stats(
        G, kp, lens.ctypes.data, tp, tic.ctypes.data, vp, tvc.ctypes.data,
        int(BIG), out_keys.ctypes.data, tmin.ctypes.data, tmax.ctypes.data,
        nmiss.ctypes.data, nnz.ctypes.data, mmin.ctypes.data,
        mmax.ctypes.data, count.ctypes.data,
    )
    out = _fold_stats_to_taxa(
        tree, tmin[:m], tmax[:m], nmiss[:m], nnz[:m], mmin[:m], mmax[:m]
    )
    uk = out_keys[:m].copy()
    if want_counts:
        return uk, out.astype(np.uint32), count[:m].astype(np.int64)
    return uk, out.astype(np.uint32)


def lca_fold_pairs(keys: np.ndarray, taxa: np.ndarray, tree: TaxTree):
    """Reduce duplicate keys by LCA-folding their taxa.  Single pass:
    sort by key, then per-run set-LCA via the Euler-interval fact
    LCA(S) = LCA(argmin tin, argmax tin) with np.minimum/maximum.reduceat —
    no iterative pairwise rounds.  Semantics match the reference's iterated
    pairwise lca (util.h:634-663): 0 is the identity, a taxid absent from
    the tree poisons the fold to TAX_MISSING (unless every non-zero element
    is that same missing taxid), and a disjoint-root pair resolves to 1.
    LCA is associative/commutative so the result is order-independent and
    deterministic.  Returns sorted unique (keys, taxa)."""
    if keys.size == 0:
        return keys.astype(np.uint64), taxa.astype(np.uint32)
    keys, t = _sort_pairs_by_key(keys, taxa)
    first = np.empty(len(keys), dtype=bool)
    first[0] = True
    first[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(first)
    uk = keys[starts]
    if starts.size == len(keys):  # all keys unique
        return uk, t
    # taxa domains are tiny (one value per genome): compact the unique
    # values, not all ~N elements (searchsorted into the tiny set is much
    # cheaper than np.unique's return_inverse machinery)
    ut = np.unique(t)
    inv = np.searchsorted(ut, t)
    cu = tree.compact(ut, missing_ok=True)
    c = cu[inv]
    n = tree.tin.shape[0]
    BIG = np.int32(2 * n + 4)
    node_of_tin = np.zeros(int(tree.tin.max()) + 2, dtype=np.int32)
    node_of_tin[tree.tin[1:]] = np.arange(1, n, dtype=np.int32)
    tin_u = np.where(cu != 0, tree.tin[cu], BIG)  # absent/0 -> +inf for min
    tins = tin_u[inv]
    tmin = np.minimum.reduceat(tins, starts)
    tmax = np.maximum.reduceat(np.where(tins == BIG, np.int32(-2), tins), starts)
    has_pres = tmax >= 0
    a = node_of_tin[np.where(has_pres, tmin, 0)]
    b = node_of_tin[np.where(has_pres, tmax, 0)]
    # (a, b) take at most |ut|^2 distinct values (tmin/tmax come from the
    # tiny per-taxon tin set): binary-lift LCA only the distinct pairs and
    # gather, instead of lifting all ~|uk| pairs (the build's former
    # single biggest cost)
    pres_mask = np.zeros(n, dtype=bool)
    pres_mask[a] = True
    pres_mask[b] = True
    dom = np.flatnonzero(pres_mask)
    if dom.size <= 1024:
        rank = np.cumsum(pres_mask, dtype=np.int32) - 1
        ai = rank[a]
        bi = rank[b]
        la, lb = np.meshgrid(dom, dom, indexing="ij")
        lca_tab = tree._lca_compact(
            la.ravel().astype(np.int32), lb.ravel().astype(np.int32)
        ).reshape(dom.size, dom.size)
        r = lca_tab[ai, bi]
    else:
        r = tree._lca_compact(a, b)
    out = tree.original(r).astype(np.uint32)
    out = np.where(has_pres & (r == 0), np.uint32(1), out)  # disjoint roots
    clean = bool(((cu != 0) | (ut == 0)).all())
    if not clean or bool((ut == 0).any()):
        # slow path: zeros and/or missing taxids present somewhere
        nz = t != 0
        pres = c != 0
        miss = nz & ~pres
        n_pres = np.add.reduceat(pres.astype(np.int64), starts)
        n_miss = np.add.reduceat(miss.astype(np.int64), starts)
        n_nz = np.add.reduceat(nz.astype(np.int64), starts)
        # missing-taxid poisoning: all-equal-missing keeps the value
        mmin = np.minimum.reduceat(
            np.where(miss, t, np.uint32(0xFFFFFFFF)), starts
        )
        mmax = np.maximum.reduceat(np.where(miss, t, np.uint32(0)), starts)
        all_same_missing = (n_pres == 0) & (n_miss > 0) & (mmin == mmax)
        out = np.where(
            (n_miss > 0) & ~all_same_missing, np.uint32(0xFFFFFFFF), out
        )
        out = np.where(all_same_missing, mmin, out)
        out = np.where(n_nz == 0, np.uint32(0), out)
    return uk, out.astype(np.uint32)


# -- map builders (make_map equivalents, feature_min.h:93-203) ----------------

def _gather_genomes(
    paths: Sequence[str],
    sp: Spacer,
    name_map: Dict[str, int],
    canonicalize: bool,
    scheme: str,
    input_type: InputType,
    score_map=None,
    use_device: bool = False,
):
    """[(taxid, sorted distinct kmers)] per genome."""
    out = []
    for p in paths:
        taxid = taxid_for_path(p, name_map)
        kset = genome_kmer_set(p, sp, canonicalize, scheme, input_type,
                               score_map, use_device)
        out.append((taxid, kset))
    return out


class IncrementalLCABuilder:
    """Streaming, checkpointable LCA-map construction.

    The reference's async-future build farm (feature_min.h:93-171) holds
    every genome's set until fold-in and cannot resume a crashed build
    (SURVEY §5: no checkpoint/resume).  LCA-merge is associative and
    commutative, so the running state (sorted keys + folded taxa) is a
    complete checkpoint: genomes fold in per batch, and a crash resumes
    from the last saved state + list of processed paths."""

    def __init__(self, tree: TaxTree, checkpoint_path: str | None = None,
                 fold_every: int = 8, checkpoint_every_folds: int = 1):
        self.tree = tree
        self.checkpoint_path = checkpoint_path
        self.fold_every = fold_every
        # at config-5 scale a checkpoint writes the full multi-GB state;
        # space them out (the resume granularity is the trade-off)
        self.checkpoint_every_folds = checkpoint_every_folds
        self._folds_since_ckpt = 0
        self.keys = np.zeros(0, np.uint64)
        self.taxa = np.zeros(0, np.uint32)
        self.done: list = []
        self._buf_k: list = []
        self._buf_t: list = []
        self._since_fold = 0
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            with np.load(checkpoint_path, allow_pickle=False) as z:
                self.keys = z["keys"]
                self.taxa = z["taxa"]
                self.done = [p.decode() for p in z["done"]]

    def pending(self, paths: Sequence[str]) -> list:
        done = set(self.done)
        return [p for p in paths if p not in done]

    def add_genome(self, path: str, taxid: int, kset: np.ndarray):
        self._buf_k.append(kset)
        self._buf_t.append(int(taxid))
        self.done.append(path)
        self._since_fold += 1
        if self._since_fold >= self.fold_every:
            self.fold()
            self._folds_since_ckpt += 1
            if (self.checkpoint_path is not None
                    and self._folds_since_ckpt
                    >= self.checkpoint_every_folds):
                self.save_checkpoint()
                self._folds_since_ckpt = 0

    def fold(self):
        if not self._buf_k:
            return
        self.keys, self.taxa = lca_fold_runs(
            self.keys, self.taxa, list(zip(self._buf_k, self._buf_t)),
            self.tree,
        )
        self._buf_k, self._buf_t = [], []
        self._since_fold = 0

    def save_checkpoint(self):
        self.fold()
        tmp = self.checkpoint_path + ".tmp.npz"
        np.savez(
            tmp[: -len(".npz")],
            keys=self.keys,
            taxa=self.taxa,
            done=np.array([p.encode() for p in self.done]),
        )
        os.replace(tmp, self.checkpoint_path)

    def finish(self) -> KmerTable:
        self.fold()
        return KmerTable(self.keys, self.taxa.astype(np.uint32))

    def finish_arrays(self):
        """(keys_sorted, taxa) WITHOUT building the probe table — the
        config-5 scale path: a 10^9-key global cuckoo placement costs
        tens of GB of transients for a structure the sharded savers /
        per-rank loaders rebuild per shard anyway."""
        self.fold()
        return self.keys, self.taxa.astype(np.uint32)


def lca_map(
    paths: Sequence[str],
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    canonicalize: bool = True,
    scheme: str = "lex",
    input_type: InputType = InputType.DNA,
    use_device: bool = False,
    checkpoint_path: str | None = None,
    block: int = 1 << 22,
    as_arrays: bool = False,
    checkpoint_every_folds: int = 1,
) -> KmerTable:
    """Phase-2 classify DB: kmer -> LCA taxid (feature_min.h:178-183,
    205-228).  With checkpoint_path, the build streams genome-by-genome
    and resumes after a crash.  as_arrays=True returns the sorted
    (keys, taxa) arrays without building the probe table (config-5
    scale path; see finish_arrays)."""
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    builder = IncrementalLCABuilder(
        tree, checkpoint_path, checkpoint_every_folds=checkpoint_every_folds
    )
    pending = builder.pending(list(paths))
    # genome extraction farm (the reference's std::async fill_set_genome
    # pool, feature_min.h:93-171): the native kmer-set kernel releases
    # the GIL, so a small thread pool overlaps parsing/extraction across
    # genomes; fold-in stays in submission order (LCA-merge is
    # associative+commutative, so content is order-independent anyway).
    import concurrent.futures as cf

    workers = min(4, max(len(pending), 1), os.cpu_count() or 1)
    with cf.ThreadPoolExecutor(workers) as pool:
        # bounded in-flight window: fold-in consumes serially in submission
        # order, so submitting everything up front would accumulate
        # completed kmer sets ahead of the fold (peak host RAM O(corpus));
        # keep at most ~2*workers genomes extracted-but-unfolded instead
        from collections import deque

        def submit(p):
            return pool.submit(genome_kmer_set, p, sp, canonicalize, scheme,
                               input_type, use_device=use_device, block=block)

        window = 2 * workers
        queue = deque(
            (p, submit(p)) for p in pending[:window]
        )
        nxt = window
        while queue:
            p, f = queue.popleft()
            builder.add_genome(p, taxid_for_path(p, name_map), f.result())
            if nxt < len(pending):
                queue.append((pending[nxt], submit(pending[nxt])))
                nxt += 1
    if checkpoint_path is not None:
        builder.save_checkpoint()
    return builder.finish_arrays() if as_arrays else builder.finish()


def taxdepth_map(
    paths: Sequence[str],
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    canonicalize: bool = True,
    input_type: InputType = InputType.DNA,
    use_device: bool = False,
) -> KmerTable:
    """Phase-1 map: kmer -> TDencode(depth, lca-taxid) (feature_min.h:198-203,
    230-250)."""
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    gs = _gather_genomes(paths, sp, name_map, canonicalize, "lex", input_type,
                         use_device=use_device)
    k, v = lca_fold_runs(
        np.zeros(0, np.uint64), np.zeros(0, np.uint32),
        [(kset, t) for t, kset in gs], tree,
    )
    depths = tree.depth_of(v)
    packed = np.where(
        v == np.uint32(TAX_T_MAX), np.uint64(1), TDencode(depths, v)
    )
    return KmerTable(k, packed.astype(np.uint64))


def ftct_map(
    paths: Sequence[str],
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    canonicalize: bool = True,
    input_type: InputType = InputType.DNA,
    use_device: bool = False,
) -> KmerTable:
    """Phase-1 feature-count map: kmer -> (n_genomes << 32) | lca-taxid
    (feature_min.h:192-197,251-265, as intended)."""
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    gs = _gather_genomes(paths, sp, name_map, canonicalize, "lex", input_type,
                         use_device=use_device)
    # counts: number of genomes containing the kmer (group multiplicity)
    k, v, counts = lca_fold_runs(
        np.zeros(0, np.uint64), np.zeros(0, np.uint32),
        [(kset, t) for t, kset in gs], tree, want_counts=True,
    )
    packed = FMencode(np.minimum(counts, TAX_T_MAX), v)
    return KmerTable(k, packed.astype(np.uint64))


def minimized_map(
    paths: Sequence[str],
    phase1: KmerTable,
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    canonicalize: bool = True,
    input_type: InputType = InputType.DNA,
    use_device: bool = False,
) -> KmerTable:
    """Phase-2 from phase-1: re-encode with score::Hash ordering (phase-1
    scores) and copy the low-32 (taxid) value for selected kmers
    (feature_min.h:185-190,267-281)."""
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    smap = ScoreMap(phase1)
    gs = _gather_genomes(paths, sp, name_map, canonicalize, "hash", input_type,
                         score_map=smap, use_device=use_device)
    keys = unique_u64(np.concatenate([k for _, k in gs])) if gs else np.zeros(0, np.uint64)
    vals, found = phase1.probe_np(keys)
    # All-N windows emit the canonical(OVERFLOW) == 0 sentinel, which phase 1
    # (unwindowed, N seeds dropped) never contains; such unscorable keys are
    # skipped (update_minimized_map, feature_min.h:274, as intended).
    keys, vals = keys[found], vals[found]
    return KmerTable(keys, (vals & np.uint64(TAX_T_MAX)).astype(np.uint32))
