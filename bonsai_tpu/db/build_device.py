"""Device-side database construction: sort-based deterministic fold.

The host build pipeline (db/build.py) replaces the reference's async khash
farm (/root/reference/include/bonsai/feature_min.h:93-171) with a native
k-way merge.  This module is the same algebra executed ON THE DEVICE — the
SURVEY §7 "sort-based perfect layout build": all heavy stages (k-mer
extraction, dedup, LCA merge) are XLA sorts and elementwise passes, so a
multi-Mb-genome build rides the device's sort throughput and memory
bandwidth instead of host memory bandwidth (whether that beats the host
build on a GPU is ROADMAP S6).

Algebra.  LCA-merge is associative and commutative, so a build is a fold of
per-genome distinct-minimizer sets under the reference's pairwise ``lca``
(util.h:634-663).  On device:

  * a STATE is (keys u64, pad u8, node i32, orig u32, cnt u32) arrays of a
    pow2 capacity; valid entries are sorted-unique by key, pads carry key
    U64_MAX and sort last (pad is a secondary sort key, so a *real*
    U64_MAX key still orders before pads).
  * MERGE of two states: one multi-operand ``lax.sort`` of the
    concatenation (groups have <= 2 real members because inputs are
    unique), one elementwise pairwise-LCA combine of adjacent duplicates,
    one compaction sort.  No scatter, no CAS — bit-reproducible for any
    merge tree.
  * the pairwise combine implements the reference lca() contract exactly
    (matching TaxTree.lca_pairs): lca(a,a)=a, lca(x,0)=x, a taxid missing
    from the tree -> 0xFFFFFFFF, disjoint roots -> 1.  Sequentially folding
    groups with this combiner is what the reference's update_lca_map does
    (feature_min.h:205-228), so content matches db/build.py's host fold.
  * ``cnt`` accumulates genome multiplicity (the ftct feature count) for
    free during the cross-genome merges; within-genome dedup keeps cnt=1.

Genomes stream through the batched device encoder (core/encoder.py) in
fixed-size halo-overlapped chunks, so jit sees one shape per block size.

Used by ``bonsai_tpu build/prebuild --device-build``; content equality with
the host builders is enforced by tests/test_build_device.py.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.alphabet import InputType, alphabet_of
from ..core.encoder import BatchEncoder
from ..core.spacer import Spacer
from ..io import fastx
from ..taxonomy.ncbi import parse_nameid_map, taxid_for_path
from ..taxonomy.tree import TAX_MISSING, TaxTree
from .build import TAX_T_MAX, TDencode, unique_u64
from .table import KmerTable

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


# -- device taxonomy ops -------------------------------------------------------

def _lca_compact_dev(tree_arrs, a, b):
    """Vectorized binary-lifting LCA over compact indices, on device.
    Mirrors TaxTree._lca_compact (taxonomy/tree.py) including the 0-identity
    rules; `lift` has a static number of levels per tree."""
    import jax.numpy as jnp

    lift = tree_arrs["lift"]
    depth = tree_arrs["depth"]
    parent = tree_arrs["parent"]
    a0 = a.astype(jnp.int32)
    b0 = b.astype(jnp.int32)
    a, b = a0, b0
    da = depth[a]
    db = depth[b]
    for j in range(lift.shape[0] - 1, -1, -1):
        step = jnp.int32(1 << j)
        lift_a = (da - db) >= step
        a = jnp.where(lift_a, lift[j][a], a)
        da = jnp.where(lift_a, da - step, da)
        lift_b = (db - da) >= step
        b = jnp.where(lift_b, lift[j][b], b)
        db = jnp.where(lift_b, db - step, db)
    neq = a != b
    for j in range(lift.shape[0] - 1, -1, -1):
        pa = lift[j][a]
        pb = lift[j][b]
        move = neq & (pa != pb)
        a = jnp.where(move, pa, a)
        b = jnp.where(move, pb, b)
    res = jnp.where(neq, parent[a], a)
    res = jnp.where(a0 == 0, b0, res)
    res = jnp.where(b0 == 0, jnp.where(a0 == 0, 0, a0), res)
    return res


def _combine_pair(tree_arrs, root1_node, nx, ox, ny, oy):
    """Reference-exact pairwise lca on (compact node, original taxid) pairs
    (util.h:634-663 / TaxTree.lca_pairs).  Returns (node, orig) of the fold;
    `orig` keeps the poisoning semantics (missing taxid -> TAX_MISSING) and
    `node` stays consistent (0 for missing) so further folds behave."""
    import jax.numpy as jnp

    r = _lca_compact_dev(tree_arrs, nx, ny)
    out_node = r
    out_orig = tree_arrs["tax_ids"][r]
    disjoint = (r == 0) & (nx != 0) & (ny != 0)
    out_node = jnp.where(disjoint, jnp.int32(root1_node), out_node)
    out_orig = jnp.where(disjoint, jnp.uint32(1), out_orig)
    missing = ((nx == 0) & (ox != jnp.uint32(0))) | (
        (ny == 0) & (oy != jnp.uint32(0))
    )
    out_node = jnp.where(missing, jnp.int32(0), out_node)
    out_orig = jnp.where(missing, jnp.uint32(TAX_MISSING), out_orig)
    # 0-identities take precedence over the missing-lookup failure
    out_node = jnp.where(ox == jnp.uint32(0), ny, out_node)
    out_orig = jnp.where(ox == jnp.uint32(0), oy, out_orig)
    take_x = (oy == jnp.uint32(0)) | (ox == oy)
    out_node = jnp.where(take_x, nx, out_node)
    out_orig = jnp.where(take_x, ox, out_orig)
    return out_node, out_orig


# -- state plumbing ------------------------------------------------------------

def _pow2(x: int) -> int:
    return 1 << max(int(max(x, 1) - 1).bit_length(), 3)


def _tree_device(tree: TaxTree):
    arrs = tree.device_arrays()
    root1 = int(tree.compact(np.array([1], dtype=np.uint32),
                             missing_ok=True)[0])
    return arrs, root1


@functools.lru_cache(maxsize=1)
def _merge_states_jit():
    import jax

    return jax.jit(
        _merge_states_impl, static_argnames=("sum_counts", "root1_node")
    )


def _merge_states_impl(ka, pa, na, oa, ca, kb, pb, nb, ob, cb, tree_arrs,
                       sum_counts: bool, root1_node: int):
    """Merge two sorted-unique padded states: sort, combine adjacent
    duplicates, compact.  Returns (keys, pad, node, orig, cnt, n_valid)."""
    import jax
    import jax.numpy as jnp

    keys = jnp.concatenate([ka, kb])
    pad = jnp.concatenate([pa, pb])
    node = jnp.concatenate([na, nb])
    orig = jnp.concatenate([oa, ob])
    cnt = jnp.concatenate([ca, cb])
    keys, pad, node, orig, cnt = jax.lax.sort(
        (keys, pad, node, orig, cnt), num_keys=2
    )
    nxt_same = jnp.concatenate(
        [keys[:-1] == keys[1:], jnp.zeros(1, dtype=bool)]
    )
    real = pad == 0
    nxt_real = jnp.concatenate([real[1:], jnp.zeros(1, dtype=bool)])
    dup = nxt_same & real & nxt_real  # first member of a 2-group
    ny = jnp.roll(node, -1)
    oy = jnp.roll(orig, -1)
    cy = jnp.roll(cnt, -1)
    cn, co = _combine_pair(tree_arrs, root1_node, node, orig, ny, oy)
    node = jnp.where(dup, cn, node)
    orig = jnp.where(dup, co, orig)
    if sum_counts:
        cnt = jnp.where(dup, cnt + cy, cnt)
    # drop the second member of each group: mark as pad, key -> U64_MAX
    prev_dup = jnp.concatenate([jnp.zeros(1, dtype=bool), dup[:-1]])
    pad = jnp.where(prev_dup, jnp.uint8(1), pad)
    keys = jnp.where(prev_dup, jnp.uint64(0xFFFFFFFFFFFFFFFF), keys)
    keys, pad, node, orig, cnt = jax.lax.sort(
        (keys, pad, node, orig, cnt), num_keys=2
    )
    n_valid = jnp.sum((pad == 0).astype(jnp.int32))
    return keys, pad, node, orig, cnt, n_valid


@functools.lru_cache(maxsize=1)
def _dedup_chunk_jit():
    import jax

    return jax.jit(_dedup_chunk_impl)


def _dedup_chunk_impl(keys, pad):
    """Sort one raw emission chunk and drop duplicate keys (all members of
    a within-genome group are identical, so keep group-first only)."""
    import jax
    import jax.numpy as jnp

    keys, pad = jax.lax.sort((keys, pad), num_keys=2)
    prev_same = jnp.concatenate(
        [jnp.zeros(1, dtype=bool), keys[1:] == keys[:-1]]
    )
    real = pad == 0
    prev_real = jnp.concatenate([jnp.zeros(1, dtype=bool), real[:-1]])
    drop = prev_same & real & prev_real
    pad = jnp.where(drop, jnp.uint8(1), pad)
    keys = jnp.where(drop, jnp.uint64(0xFFFFFFFFFFFFFFFF), keys)
    keys, pad = jax.lax.sort((keys, pad), num_keys=2)
    return keys, pad, jnp.sum((pad == 0).astype(jnp.int32))


class _State:
    """Sorted-unique padded device state (see module docstring)."""

    __slots__ = ("keys", "pad", "node", "orig", "cnt", "n")

    def __init__(self, keys, pad, node, orig, cnt, n: int):
        self.keys, self.pad, self.node, self.orig, self.cnt = (
            keys, pad, node, orig, cnt,
        )
        self.n = n

    @classmethod
    def empty(cls, cap: int = 8):
        import jax.numpy as jnp

        return cls(
            jnp.full(cap, U64_MAX, dtype=jnp.uint64),
            jnp.ones(cap, dtype=jnp.uint8),
            jnp.zeros(cap, dtype=jnp.int32),
            jnp.zeros(cap, dtype=jnp.uint32),
            jnp.zeros(cap, dtype=jnp.uint32),
            0,
        )

    @classmethod
    def from_sorted_keys(cls, keys, pad, n: int, node: int, orig: int):
        """Constant-taxon state from an already sorted-unique padded key
        array (one genome)."""
        import jax.numpy as jnp

        real = pad == 0
        return cls(
            keys,
            pad,
            jnp.where(real, jnp.int32(node), jnp.int32(0)),
            jnp.where(real, jnp.uint32(orig), jnp.uint32(0)),
            jnp.where(real, jnp.uint32(1), jnp.uint32(0)),
            n,
        )

    def trimmed(self):
        """Slice to the pow2 capacity covering the valid prefix (valid
        entries are a prefix after compaction)."""
        cap = _pow2(self.n)
        if cap >= self.keys.shape[0]:
            return self
        return _State(
            self.keys[:cap], self.pad[:cap], self.node[:cap],
            self.orig[:cap], self.cnt[:cap], self.n,
        )


def _merge(a: _State, b: _State, tree_arrs, root1: int,
           sum_counts: bool) -> _State:
    out = _merge_states_jit()(
        a.keys, a.pad, a.node, a.orig, a.cnt,
        b.keys, b.pad, b.node, b.orig, b.cnt,
        tree_arrs, sum_counts=sum_counts, root1_node=root1,
    )
    st = _State(*out[:5], int(out[5]))
    return st.trimmed()


# -- genome streaming ----------------------------------------------------------

def _genome_state(
    path: str,
    sp: Spacer,
    enc: BatchEncoder,
    lut: np.ndarray,
    taxid: int,
    node: int,
    tree_arrs,
    root1: int,
    block: int,
) -> _State:
    """One genome -> folded device state (distinct emitted minimizers with
    the genome's constant taxid).  Contigs stream in halo-overlapped
    fixed-shape chunks (same chunk semantics as db/build._contig_sets)."""
    import jax.numpy as jnp

    halo = sp.w - 1
    span = sp.c
    chunk_len = block + halo
    acc = _State.empty()
    # Deferred-sync pipeline: the naive loop paid
    # TWO host round-trips per chunk (int(nv) after dedup, int(n) after
    # merge), serializing host parse/encode with device compute.  Here
    # the chunk state skips the nv sync entirely (its n only drove a
    # trim; merges recount from pads), and the accumulator's post-merge
    # n resolves ONE ITERATION LATE — while the host encodes the next
    # chunk, the device runs the previous merge, and the deferred int()
    # lands on a finished value.  Host prep and device folds overlap;
    # trims still happen every iteration (capacity stays bounded).
    acc_out = None  # un-materialized merge output (arrays + n scalar)

    def _resolve(out):
        return _State(*out[:5], int(out[5])).trimmed()

    for _, seq, _ in fastx.read_fastx(path):
        if len(seq) < span:
            continue
        n = len(seq)
        start = 0
        while start < n:
            end = min(start + block + halo, n)
            sub = seq[start:end]
            is_last = end >= n
            codes = np.full((1, chunk_len), -1, dtype=np.int8)
            codes[0, : len(sub)] = fastx.encode_contig(sub, lut)
            lengths = np.array([len(sub)], dtype=np.int32)
            em = enc.emissions(jnp.asarray(codes), jnp.asarray(lengths))
            mask = em.mask
            if not is_last and sp.w > sp.c and not enc.canon:
                # windowed uncanon: the trailing partial emission of a
                # non-final chunk is not a real contig end (slot 0 by
                # construction; see db/build._contig_sets)
                mask = mask.at[:, 0].set(False)
            keys = jnp.where(mask[0], em.values[0], U64_MAX)
            pad = (~mask[0]).astype(jnp.uint8)
            dk, dp, _nv = _dedup_chunk_jit()(keys, pad)
            if acc_out is not None:
                acc = _resolve(acc_out)  # overlaps this chunk's device work
            st = _State.from_sorted_keys(
                dk, dp, int(dk.shape[0]), node, taxid
            )
            acc_out = _merge_states_jit()(
                acc.keys, acc.pad, acc.node, acc.orig, acc.cnt,
                st.keys, st.pad, st.node, st.orig, st.cnt,
                tree_arrs, sum_counts=False, root1_node=root1,
            )
            if is_last:
                break
            start += block
    if acc_out is not None:
        acc = _resolve(acc_out)
    return acc


def device_fold_runs(
    runs: Sequence[Tuple[np.ndarray, int]],
    tree: TaxTree,
    want_counts: bool = False,
):
    """Device analog of db/build.lca_fold_runs on explicit per-genome
    sorted-unique key sets: tree-reduced merge fold.  Returns host
    (keys, taxa[, counts])."""
    import jax.numpy as jnp

    tree_arrs, root1 = _tree_device(tree)
    states: List[_State] = []
    for kset, taxid in runs:
        kset = np.asarray(kset, dtype=np.uint64)
        node = int(
            tree.compact(np.array([taxid], dtype=np.uint32),
                         missing_ok=True)[0]
        )
        cap = _pow2(kset.size)
        keys = np.full(cap, U64_MAX, dtype=np.uint64)
        keys[: kset.size] = kset
        pad = np.ones(cap, dtype=np.uint8)
        pad[: kset.size] = 0
        states.append(
            _State.from_sorted_keys(
                jnp.asarray(keys), jnp.asarray(pad), int(kset.size),
                node, int(taxid) & 0xFFFFFFFF,
            )
        )
    return _finish_fold(states, tree_arrs, root1, want_counts)


def _finish_fold(states: List[_State], tree_arrs, root1: int,
                 want_counts: bool):
    if not states:
        out = (np.zeros(0, np.uint64), np.zeros(0, np.uint32))
        return out + ((np.zeros(0, np.int64),) if want_counts else ())
    # tree reduction: deterministic content for ANY merge order (LCA is
    # associative/commutative); pairing keeps sort sizes balanced
    while len(states) > 1:
        nxt = []
        for i in range(0, len(states) - 1, 2):
            nxt.append(
                _merge(states[i], states[i + 1], tree_arrs, root1,
                       sum_counts=True)
            )
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    st = states[0]
    keys = np.asarray(st.keys)[: st.n]
    taxa = np.asarray(st.orig)[: st.n].astype(np.uint32)
    if want_counts:
        return keys, taxa, np.asarray(st.cnt)[: st.n].astype(np.int64)
    return keys, taxa


# -- public builders -----------------------------------------------------------

def _device_gather(
    paths: Sequence[str],
    tree: TaxTree,
    name_map,
    sp: Spacer,
    canonicalize: bool,
    scheme: str,
    input_type: InputType,
    score_map=None,
    block: int = 1 << 22,
) -> Tuple[List[_State], tuple, int]:
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    enc = BatchEncoder(sp, canonicalize, scheme, InputType(input_type),
                       score_map)
    lut = alphabet_of(InputType(input_type)).lut
    tree_arrs, root1 = _tree_device(tree)
    states = []
    for p in paths:
        taxid = taxid_for_path(p, name_map)
        node = int(
            tree.compact(np.array([taxid], dtype=np.uint32),
                         missing_ok=True)[0]
        )
        states.append(
            _genome_state(p, sp, enc, lut, int(taxid) & 0xFFFFFFFF, node,
                          tree_arrs, root1, block)
        )
    return states, tree_arrs, root1


def device_lca_map(
    paths: Sequence[str],
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    canonicalize: bool = True,
    scheme: str = "lex",
    input_type: InputType = InputType.DNA,
    block: int = 1 << 22,
) -> KmerTable:
    """Phase-2 classify DB built on device; content-identical to
    db/build.lca_map (feature_min.h:178-183,205-228).

    Caveat (windowed uncanonical only, -C with w > k): a window whose
    bases straddle a chunk boundary next to an in-chunk N can select a
    different minimizer than an unchunked pass, so content for that
    discipline is identical to the host build only at equal ``block``
    (both default to 1 << 22).  All other disciplines are block-size
    invariant."""
    states, tree_arrs, root1 = _device_gather(
        paths, tree, name_map, sp, canonicalize, scheme, input_type,
        block=block,
    )
    keys, taxa = _finish_fold(states, tree_arrs, root1, want_counts=False)
    return KmerTable(keys, taxa)


def device_taxdepth_map(
    paths: Sequence[str],
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    canonicalize: bool = True,
    input_type: InputType = InputType.DNA,
    block: int = 1 << 22,
) -> KmerTable:
    """Phase-1 tax-depth map on device (feature_min.h:198-203,230-250):
    kmer -> TDencode(depth, lca)."""
    states, tree_arrs, root1 = _device_gather(
        paths, tree, name_map, sp, canonicalize, "lex", input_type,
        block=block,
    )
    k, v = _finish_fold(states, tree_arrs, root1, want_counts=False)
    depths = tree.depth_of(v)
    packed = np.where(
        v == np.uint32(TAX_T_MAX), np.uint64(1), TDencode(depths, v)
    )
    return KmerTable(k, packed.astype(np.uint64))


def device_ftct_map(
    paths: Sequence[str],
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    canonicalize: bool = True,
    input_type: InputType = InputType.DNA,
    block: int = 1 << 22,
) -> KmerTable:
    """Phase-1 feature-count map on device (feature_min.h:192-197,251-265
    as intended): kmer -> (n_genomes << 32) | lca."""
    states, tree_arrs, root1 = _device_gather(
        paths, tree, name_map, sp, canonicalize, "lex", input_type,
        block=block,
    )
    k, v, counts = _finish_fold(states, tree_arrs, root1, want_counts=True)
    packed = (
        np.minimum(counts, TAX_T_MAX).astype(np.uint64) << np.uint64(32)
    ) | v.astype(np.uint64)
    return KmerTable(k, packed.astype(np.uint64))


# -- multi-device sharded fold ------------------------------------------------

class ShardedLCAFold:
    """Key-range-sharded LCA fold over a mesh 'db' axis (SURVEY §2.10: the
    DB-build communication backbone).

    Each rank owns a key range [splitter[r-1], splitter[r]) and folds only
    the stream elements in its range — shard-local ownership means no
    cross-device merge traffic at all (the stream is replicated; ranks
    filter).  Every rank runs the same sort-based merge as the single-device
    fold (_merge_states_impl), so per-shard content is sorted-unique and the
    global result is the range-ordered concatenation.  LCA-merge being
    associative/commutative makes the outcome independent of chunk order and
    of the shard count — content-identical to db/build.lca_map.

    Capacity is static per rank (XLA shapes); `add_chunk` returns per-rank
    valid counts so the caller can detect (and re-run with a larger cap on)
    overflow — entries past cap would otherwise be dropped silently.
    """

    def __init__(self, tree: TaxTree, mesh, cap: int,
                 splitters: np.ndarray | None = None):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.tree = tree
        self.mesh = mesh
        self.ndb = mesh.shape["db"]
        self.cap = int(cap)
        self.tree_arrs, self.root1 = _tree_device(tree)
        if splitters is None:
            # even split of the key space; pass sampled quantiles for
            # balanced shards on skewed (e.g. canonical-kmer) keys
            step = (1 << 64) // self.ndb
            splitters = np.array(
                [step * i for i in range(1, self.ndb)], dtype=np.uint64
            )
        assert splitters.shape == (self.ndb - 1,)
        self._splitters = jnp.asarray(
            np.concatenate(
                [splitters.astype(np.uint64),
                 np.array([0xFFFFFFFFFFFFFFFF], dtype=np.uint64)]
            )
        )
        shard = NamedSharding(mesh, P("db"))
        n = self.ndb * self.cap
        self.keys = jax.device_put(
            jnp.full(n, U64_MAX, dtype=jnp.uint64), shard
        )
        self.pad = jax.device_put(jnp.ones(n, dtype=jnp.uint8), shard)
        self.node = jax.device_put(jnp.zeros(n, dtype=jnp.int32), shard)
        self.orig = jax.device_put(jnp.zeros(n, dtype=jnp.uint32), shard)
        self.cnt = jax.device_put(jnp.zeros(n, dtype=jnp.uint32), shard)
        self._fns = {}

    def _fn(self, E: int):
        if E in self._fns:
            return self._fns[E]
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        tree_arrs = self.tree_arrs
        root1 = self.root1
        cap = self.cap
        ndb = self.ndb

        def local(keys, pad, node, orig, cnt, ck, cp, cnode, corig, spl):
            r = jax.lax.axis_index("db")
            lo = jnp.where(r == 0, jnp.uint64(0), spl[0][r - 1])
            hi = spl[0][r]
            last = r == ndb - 1
            # foreign keys -> pad (hi is inclusive only on the last rank)
            mine = (ck >= lo) & ((ck < hi) | (last & (ck <= hi)))
            mine = mine & (cp == 0)
            ck = jnp.where(mine, ck, jnp.uint64(0xFFFFFFFFFFFFFFFF))
            cp = jnp.where(mine, jnp.uint8(0), jnp.uint8(1))
            dk, dp, _ = _dedup_chunk_impl(ck, cp)
            real = dp == 0
            out = _merge_states_impl(
                keys, pad, node, orig, cnt,
                dk, dp,
                jnp.where(real, cnode[0], jnp.int32(0)),
                jnp.where(real, corig[0], jnp.uint32(0)),
                jnp.where(real, jnp.uint32(1), jnp.uint32(0)),
                tree_arrs, sum_counts=False, root1_node=root1,
            )
            nk, np_, nn, no, nc, nv = out
            return nk[:cap], np_[:cap], nn[:cap], no[:cap], nc[:cap], nv[None]

        fn = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P("db"), P("db"), P("db"), P("db"), P("db"),
                P(), P(), P(), P(), P(None),
            ),
            out_specs=(P("db"),) * 5 + (P("db"),),
        )
        self._fns[E] = jax.jit(fn)
        return self._fns[E]

    def add_chunk(self, keys, pad, node: int, orig: int):
        """Fold one genome-chunk stream (replicated (E,) arrays) into every
        rank's range.  Raises on shard-capacity overflow."""
        import jax.numpy as jnp

        E = int(keys.shape[0])
        fn = self._fn(E)
        out = fn(
            self.keys, self.pad, self.node, self.orig, self.cnt,
            keys, pad,
            jnp.full(1, node, dtype=jnp.int32),
            jnp.full(1, orig, dtype=jnp.uint32),
            self._splitters[None, :],
        )
        nv = np.asarray(out[5])
        if (nv > self.cap).any():
            # do NOT commit the cap-truncated state (it already dropped
            # keys); leaving self.* at the pre-chunk state keeps the fold
            # usable for inspection, but the chunk is lost — callers must
            # rebuild with a larger cap
            raise RuntimeError(
                f"shard capacity {self.cap} exceeded: per-rank valid={nv}; "
                "re-run with a larger cap"
            )
        self.keys, self.pad, self.node, self.orig, self.cnt = out[:5]

    def finish(self):
        """(keys, taxa) host arrays — globally sorted unique (ranges are
        ascending by rank)."""
        keys = np.asarray(self.keys).reshape(self.ndb, self.cap)
        pad = np.asarray(self.pad).reshape(self.ndb, self.cap)
        orig = np.asarray(self.orig).reshape(self.ndb, self.cap)
        ks, ts = [], []
        for r in range(self.ndb):
            m = pad[r] == 0
            ks.append(keys[r][m])
            ts.append(orig[r][m])
        return np.concatenate(ks), np.concatenate(ts).astype(np.uint32)


def sharded_lca_map(
    paths: Sequence[str],
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    mesh,
    canonicalize: bool = True,
    scheme: str = "lex",
    input_type: InputType = InputType.DNA,
    block: int = 1 << 22,
    cap: int | None = None,
) -> KmerTable:
    """Phase-2 LCA DB built across a mesh 'db' axis; content-identical to
    db/build.lca_map.  `cap` is the per-shard key capacity (default: a
    generous estimate from total input bases)."""
    import jax.numpy as jnp

    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    enc = BatchEncoder(sp, canonicalize, scheme, InputType(input_type))
    lut = alphabet_of(InputType(input_type)).lut
    ndb = mesh.shape["db"]
    if cap is None:
        total = sum(os.path.getsize(p) for p in paths)
        # ~1 distinct kmer per base upper bound, 2x gz expansion, 1.5 margin
        est = total * (3 if any(p.endswith(".gz") for p in paths) else 1)
        cap = _pow2(int(est * 1.5 / ndb) + (1 << 12))

    def chunks():
        import jax.numpy as jnp

        halo = sp.w - 1
        chunk_len = block + halo
        for p in paths:
            taxid = taxid_for_path(p, name_map)
            node = int(
                tree.compact(np.array([taxid], dtype=np.uint32),
                             missing_ok=True)[0]
            )
            for _, seq, _ in fastx.read_fastx(p):
                if len(seq) < sp.c:
                    continue
                n = len(seq)
                start = 0
                while start < n:
                    end = min(start + block + halo, n)
                    sub = seq[start:end]
                    is_last = end >= n
                    codes = np.full((1, chunk_len), -1, dtype=np.int8)
                    codes[0, : len(sub)] = fastx.encode_contig(sub, lut)
                    lengths = np.array([len(sub)], dtype=np.int32)
                    em = enc.emissions(
                        jnp.asarray(codes), jnp.asarray(lengths)
                    )
                    mask = em.mask
                    if not is_last and sp.w > sp.c and not enc.canon:
                        mask = mask.at[:, 0].set(False)
                    keys = jnp.where(mask[0], em.values[0], U64_MAX)
                    pad = (~mask[0]).astype(jnp.uint8)
                    yield keys, pad, node, int(taxid) & 0xFFFFFFFF
                    if is_last:
                        break
                    start += block

    stream = chunks()
    # balanced key-range splitters from several leading chunks' quantiles
    # (kmer keys occupy [0, 4^k) and skew toward canonical minima; an even
    # 64-bit split would land everything on rank 0).  Sampling across up
    # to 16 chunks — which spans multiple genomes for multi-file corpora —
    # guards against a degenerate or skewed first chunk.
    head = []
    sample = []
    for item in stream:
        head.append(item)
        k_, p_ = np.asarray(item[0]), np.asarray(item[1])
        sample.append(k_[p_ == 0])
        if len(head) >= 16:
            break
    if not head:
        return KmerTable(np.zeros(0, np.uint64), np.zeros(0, np.uint32))
    fk = np.concatenate(sample) if sample else np.zeros(0, np.uint64)
    splitters = None
    if fk.size >= ndb:
        qs = np.quantile(fk.astype(np.float64), np.arange(1, ndb) / ndb)
        qs = np.minimum(qs, np.nextafter(2.0**64, 0.0))
        splitters = np.unique(qs.astype(np.uint64))
        if splitters.size < ndb - 1:  # degenerate: fall back to even split
            splitters = None
    if splitters is None and 2 * sp.k < 64:
        # even split of the actual kmer domain [0, 4^k), not of u64
        dom = np.uint64(1) << np.uint64(2 * sp.k)
        splitters = (np.arange(1, ndb, dtype=np.uint64) * dom) // np.uint64(
            ndb
        )
    fold = ShardedLCAFold(tree, mesh, cap, splitters=splitters)
    import itertools

    for keys, pad, node, orig in itertools.chain(head, stream):
        fold.add_chunk(keys, pad, node, orig)
    keys, taxa = fold.finish()
    return KmerTable(keys, taxa)


def device_minimized_map(
    paths: Sequence[str],
    phase1: KmerTable,
    tree: TaxTree,
    name_map: Dict[str, int] | str,
    sp: Spacer,
    canonicalize: bool = True,
    input_type: InputType = InputType.DNA,
    block: int = 1 << 22,
) -> KmerTable:
    """Phase-2 minimized map with device encoding under score::Hash
    ordering (feature_min.h:185-190,267-281)."""
    from .table import ScoreMap

    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    smap = ScoreMap(phase1)
    states, tree_arrs, root1 = _device_gather(
        paths, tree, name_map, sp, canonicalize, "hash", input_type,
        score_map=smap, block=block,
    )
    keys, _ = _finish_fold(states, tree_arrs, root1, want_counts=False)
    keys = unique_u64(keys)
    vals, found = phase1.probe_np(keys)
    keys, vals = keys[found], vals[found]
    return KmerTable(keys, (vals & np.uint64(TAX_T_MAX)).astype(np.uint32))
