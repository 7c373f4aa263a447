"""The classifier: batched encode -> table probe -> resolve, under jit.

Accelerator-native redesign of ClassifierGeneric / classify_seq / process_dataset
(/root/reference/include/bonsai/classifier.h:131-337).  The reference farms
32-read slices across a work-stealing thread pool, each read probing a
shared khash; here a whole read batch is one traced device computation:

  codes (B, L) --encode--> kmers (B, P) --probe--> compact taxids (B, P)
              --interval-rank resolve--> taxon (B,)

Per the reference CLI, classification always runs unwindowed with w = k
regardless of the DB's build window (bin/bonsai.cpp:152 passes db.k_ for
wsz), canonical by default.

Host side handles FASTA/FASTQ batching and text output; device-host overlap
comes from jax's async dispatch (the next batch is encoded while the device
classifies the current one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.alphabet import InputType, alphabet_of
from ..core.encoder import BatchEncoder
from ..core.spacer import Spacer
from ..db.formats import Database
from ..io import fastx
from ..taxonomy.tree import TaxTree
from . import output as out_mod
from .resolve import resolve_batch


@dataclass
class BatchResult:
    """One row per classification unit: a read, or a mate PAIR when paired
    (the reference classifies pairs as one unit, classifier.h:236-240).

    The per-kmer hit information comes in one of two shapes:
      * full: ``taxa`` (R, W) + ``hit_mask`` (R, W) positional matrices;
      * compact: ``run_vals``/``run_lens`` (R, MAXR) device-side
        run-length encoding of the hit-taxa stream (the only thing the
        Kraken output needs) — ~20 B/read fetched in dictionary mode
        (vs 60 B for plain u32 runs; see build_step_outputs).
    ``hit_taxa(i)`` yields the per-read hit stream in either mode."""

    names: List[bytes]
    seqs: List[bytes]
    quals: List[Optional[bytes]]
    lengths: np.ndarray  # (R,) mate-1 lengths
    taxon: np.ndarray  # (R,) original taxids, 0 = unclassified
    taxa: Optional[np.ndarray]  # (R, W) original taxids of DB hits, or None
    hit_mask: Optional[np.ndarray]  # (R, W), or None (compact mode)
    n_missing: np.ndarray  # (R,) total missing (both mates)
    n_kmers: np.ndarray  # (R,) total valid kmers (both mates)
    n_kmers1: Optional[np.ndarray] = None  # (R,) mate-1 valid kmers
    # compact (run-length) hit representation, None in full mode
    run_vals: Optional[np.ndarray] = None  # (R, MAXR) run taxids
    run_lens: Optional[np.ndarray] = None  # (R, MAXR) run lengths
    n_runs: Optional[np.ndarray] = None  # (R,) true run counts (<= MAXR here)
    # mate-2 fields, None for single-end
    lengths2: Optional[np.ndarray] = None
    seqs2: Optional[List[bytes]] = None
    quals2: Optional[List[Optional[bytes]]] = None

    @property
    def paired(self) -> bool:
        return self.lengths2 is not None

    @property
    def compact(self) -> bool:
        return self.run_vals is not None

    def hit_taxa(self, i: int) -> np.ndarray:
        """Hit-taxa stream of read i (taxids of DB hits in kmer order)."""
        if self.run_vals is not None:
            r = int(self.n_runs[i])
            return np.repeat(self.run_vals[i, :r], self.run_lens[i, :r])
        return self.taxa[i][self.hit_mask[i]]


def unpack_2bit(pcodes, nmask=None):
    """(B, L/16) u32 2-bit-packed codes [+ (B, L/32) u32 N-bitmask] ->
    (B, L) int8 codes (a few fused shifts; shared by the single-device
    and sharded steps).

    nmask=None is the no-N fast path: when the host sees no ambiguous
    base inside any read of the batch it skips the bitmask upload
    entirely (a third of the host->device bytes); positions past each
    read's length decode as code 0, which the position-validity mask
    already excludes for the unwindowed classify discipline."""
    import jax.numpy as jnp

    B, L16 = pcodes.shape
    shifts = jnp.arange(16, dtype=jnp.uint32) * 2
    c = (
        ((pcodes[:, :, None] >> shifts) & jnp.uint32(3))
        .astype(jnp.int8)
        .reshape(B, L16 * 16)
    )
    if nmask is None:
        return c
    mshift = jnp.arange(32, dtype=jnp.uint32)
    nm = (
        ((nmask[:, :, None] >> mshift) & jnp.uint32(1)) != 0
    ).reshape(B, nmask.shape[1] * 32)[:, : L16 * 16]
    return jnp.where(nm, jnp.int8(-1), c)


def dict_layout(dict_size: int, W: int):
    """(vb, lb, head_words) of the dictionary compact layout — the ONE
    definition shared by the device packer (build_step_outputs) and the
    host decoder (_finish_arrays); drift between the two would silently
    corrupt every decoded field."""
    vb = 4 if dict_size <= 16 else (8 if dict_size <= 256 else 16)
    lb = 8 if W <= 255 else 16
    head_words = 2 if W <= 255 else 3
    return vb, lb, head_words


def build_step_outputs(taxon, taxa, hit, valid, valid1, maxr,
                       dict_size: Optional[int] = None):
    """Device-side (compact, full) output matrices from per-position
    classify results — shared by the single-chip and sharded steps so
    both host pipelines fetch the same byte-light layout.

    taxon (R,) u32 resolved taxids; taxa (R, W) u32 hit taxids (0 where
    no hit); hit/valid (R, W); valid1 (R,) u32 mate-1 kmer counts;
    maxr = compact run capacity.

    dict_size (the DB's distinct-value count) means ``taxa`` holds
    DICTIONARY INDICES into the host-replicated unique-taxid table
    instead of 32-bit taxids (the probe's value index is a free
    by-product, db/table.py probe_slots_device want_idx); the host maps
    indices back after the fetch.  Run indices then pack at the
    narrowest sufficient width (4/8/16 bits), run lengths at 8 bits when
    W fits a byte, and the head at two words — 20 B/read at maxr=8 for a
    small dictionary, vs 60 B for the plain u32 layout (the reference's
    output needs only the run stream, classifier.h:112-129; the layouts
    keep host<->device bytes minimal — whether that still pays over
    PCIe is ROADMAP S4).

    * full: positional [head | hit-bitmask words | taxa] (R, 4+ceil(W/32)+W)
      (dictionary indices in the taxa block when dict_size is set)
    * compact: device-side RLE of the hit-taxa stream (append_taxa_runs,
      classifier.h:45-61); layouts:
        dict, W<=255 : [taxon | miss|kmers<<8|kmers1<<16|nruns<<24 |
                        run idx vb-bit packed | run lens 4/u32]
        dict, W<2^15 : [taxon | miss|kmers<<16 | kmers1|n_runs<<16 |
                        run idx vb-bit packed | run lens 2/u32]
        plain, W<2^15: [taxon | miss|kmers<<16 | kmers1|n_runs<<16 |
                        run_vals*maxr | run lens 2/u32]
        else         : [taxon | miss | kmers | kmers1 | n_runs |
                        run_vals*maxr | run_lens*maxr]
      with vb = 4 (dict_size <= 16), 8 (<= 256), else 16."""
    import jax.numpy as jnp
    from jax import lax

    miss = valid & ~hit
    R, W = taxa.shape
    hb = (W + 31) // 32
    if hb:
        pad = jnp.zeros((R, hb * 32 - W), dtype=bool)
        bits = jnp.concatenate([hit, pad], axis=1).reshape(R, hb, 32)
        weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
        hit_words = jnp.sum(
            bits.astype(jnp.uint32) * weights, axis=-1, dtype=jnp.uint32
        )
    else:
        hit_words = jnp.zeros((R, 0), dtype=jnp.uint32)
    head = jnp.stack(
        [
            taxon,
            miss.sum(axis=-1).astype(jnp.uint32),
            valid.sum(axis=-1).astype(jnp.uint32),
            valid1,
        ],
        axis=1,
    )
    full = jnp.concatenate([head, hit_words, taxa], axis=1)

    # RLE run boundaries via a log-depth associative last-valid scan (no
    # gathers; a handful of selects per position)
    def last_valid(a, b):
        av, ah = a
        bv, bh = b
        return jnp.where(bh, bv, av), ah | bh

    lastv, lasth = lax.associative_scan(
        (lambda a, b: last_valid(a, b)), (taxa, hit), axis=1
    )
    z32 = jnp.zeros((R, 1), dtype=taxa.dtype)
    zb = jnp.zeros((R, 1), dtype=bool)
    prev_v = jnp.concatenate([z32, lastv[:, :-1]], axis=1)
    prev_h = jnp.concatenate([zb, lasth[:, :-1]], axis=1)
    is_new = hit & (~prev_h | (taxa != prev_v))
    run_id = jnp.cumsum(is_new.astype(jnp.int32), axis=1) - 1
    n_runs = (
        jnp.sum(is_new, axis=1).astype(jnp.uint32)
        if W
        else jnp.zeros((R,), dtype=jnp.uint32)
    )
    rid = jnp.where(hit, run_id, maxr)
    onehot = rid[:, :, None] == jnp.arange(maxr, dtype=jnp.int32)
    run_lens = jnp.sum(onehot, axis=1, dtype=jnp.uint32)
    run_vals = jnp.sum(
        jnp.where(onehot & is_new[:, :, None], taxa[:, :, None], 0),
        axis=1,
        dtype=jnp.uint32,
    )
    def packbits(a, vb):
        """Pack u32 lanes of < 2^vb values into u32 words, 32//vb per
        word, little-endian within the word."""
        per = 32 // vb
        pad = (-a.shape[1]) % per
        if pad:
            a = jnp.concatenate([a, jnp.zeros((R, pad), jnp.uint32)], axis=1)
        a = a.reshape(R, -1, per)
        sh = jnp.arange(per, dtype=jnp.uint32) * vb
        return jnp.sum(a << sh, axis=-1, dtype=jnp.uint32)

    if W < (1 << 15):
        # packed layouts: every counter and run length fits 16 bits
        # because the position count W fits 15
        u16 = jnp.uint32(0xFFFF)
        if dict_size is not None:
            # run values are dictionary indices: narrowest viable width
            vb, lb, head_words = dict_layout(dict_size, W)
            vals_packed = packbits(run_vals, vb)
            lens_packed = packbits(run_lens, lb)
            if head_words == 2:
                # every head counter fits a byte: 2-word head
                h1 = (
                    head[:, 1]
                    | (head[:, 2] << 8)
                    | (head[:, 3] << 16)
                    | (n_runs << 24)
                )
                hcols = [head[:, :1], h1[:, None]]
            else:
                h1 = (head[:, 1] & u16) | (head[:, 2] << 16)
                h2 = (head[:, 3] & u16) | (n_runs << 16)
                hcols = [head[:, :1], h1[:, None], h2[:, None]]
        else:
            vals_packed = run_vals
            lens_packed = packbits(run_lens, 16)
            h1 = (head[:, 1] & u16) | (head[:, 2] << 16)
            h2 = (head[:, 3] & u16) | (n_runs << 16)
            hcols = [head[:, :1], h1[:, None], h2[:, None]]
        compact = jnp.concatenate(
            hcols + [vals_packed, lens_packed], axis=1
        )
    else:
        compact = jnp.concatenate(
            [head, n_runs[:, None], run_vals, run_lens], axis=1
        )
    return compact, full


class Classifier:
    def __init__(
        self,
        db: Database,
        tree: TaxTree,
        canonicalize: bool = True,
        emit_all: bool = False,
        emit_kraken: bool = True,
        emit_fastq: bool = False,
        input_type: InputType = InputType.DNA,
        trim_table: bool = True,
    ):
        # classify always uses w = k (bin/bonsai.cpp:152)
        self.sp = Spacer(db.k, db.k, db.gaps)
        self.enc = BatchEncoder(self.sp, canonicalize, "lex", input_type)
        self.db = db
        self.tree = tree
        self.emit_all = emit_all
        self.emit_kraken = emit_kraken
        self.emit_fastq = emit_fastq
        self.lut = alphabet_of(InputType(input_type)).lut
        self.n_classified = 0
        self.n_unclassified = 0
        # device-resident state
        import jax.numpy as jnp

        table = db.table
        compact_vals = tree.compact(table.vals_sorted, missing_ok=True)
        # One probe yields both payloads: orig taxid in the high u32 of
        # the (usually tiny unique-values) table, compact taxonomy index
        # in the low u32.
        packed = (
            table.vals_sorted.astype(np.uint64) << np.uint64(32)
        ) | compact_vals.astype(np.uint32).astype(np.uint64)
        slots_np, vals_np, inline = table.arrays_np(packed)
        self._arrays = (jnp.asarray(slots_np), jnp.asarray(vals_np), inline)
        # dictionary mode: with an inline (unique-values) table of <= 2^16
        # entries, the probe's value INDEX replaces the 32-bit taxid in the
        # compact fetch; the host maps indices back through this table.
        # orig taxid <-> packed value is 1:1 (compact idx is a function of
        # the taxid), so the index stream RLE-compresses identically.
        self._uniq_host = None
        if inline and vals_np.size <= 0xFFFF:
            self._uniq_host = (
                np.asarray(vals_np) >> np.uint64(32)
            ).astype(np.uint32)
        # a read can hit at most this many distinct taxonomy nodes — the
        # static bound the long-read dedup resolve relies on
        self._n_distinct = int(np.unique(compact_vals).size)
        if trim_table:
            # the probe runs entirely off the device copies above; free
            # the host-side layout intermediates (~40% of classify RSS;
            # they lazily rebuild on any later table use)
            table.trim()
        self._tax = tree.device_arrays()
        self._step_cache = {}
        # compact-output run capacity: reads with more distinct hit runs
        # than this fall back to fetching the full positional matrix
        import os as _os

        self.max_runs = int(_os.environ.get("BONSAI_TPU_MAX_RUNS", 8))
        # after this many full-matrix fallbacks, double max_runs (one
        # recompile) so run-rich datasets stop paying the big fetch
        self._overflow_batches = 0
        self._overflow_bump_after = 3

    @classmethod
    def from_probe_image(
        cls,
        image_path: str,
        tree: TaxTree,
        emit_all: bool = False,
        emit_kraken: bool = True,
        emit_fastq: bool = False,
        input_type: InputType = InputType.DNA,
    ):
        """Construct a classifier straight from a saved probe image
        (db/formats.py::save_probe_image): the slot words upload to the
        device directly from the mmap — no cuckoo re-placement, no
        host-side packing transients, no canonical key/value arrays in
        memory.  This is the device analog of the reference's khash
        memory-image load (util.h:281-372 + database.h:33-56), and the
        memory-lean path for long classify streams: resident set is the
        touched mmap pages + the device upload staging only."""
        import types

        import jax.numpy as jnp

        from ..db import formats as _formats
        from ..db.table import probe_slots_device

        img = _formats.load_probe_image(image_path)
        if img.tree_digest != _formats.tree_digest(tree):
            raise ValueError(
                "probe image was built against a different taxonomy "
                f"(digest {img.tree_digest})"
            )
        self = cls.__new__(cls)
        self.sp = Spacer(img.k, img.k, img.gaps)
        self.enc = BatchEncoder(
            self.sp, img.canonicalize, "lex", input_type
        )
        # a minimal stand-in for db.table: _make_step only reads
        # lgnb/vbits and calls probe_device(arrays=...)
        tbl = types.SimpleNamespace(
            lgnb=img.lgnb, vbits=img.vbits, n=img.n,
            probe_device=lambda queries, arrays=None, want_idx=False:
                probe_slots_device(
                    queries, arrays[0], arrays[1], arrays[2],
                    img.lgnb, img.vbits, want_idx,
                ),
        )
        self.db = types.SimpleNamespace(
            table=tbl, k=img.k, w=img.w, gaps=img.gaps
        )
        self.tree = tree
        self.emit_all = emit_all
        self.emit_kraken = emit_kraken
        self.emit_fastq = emit_fastq
        self.lut = alphabet_of(InputType(input_type)).lut
        self.n_classified = 0
        self.n_unclassified = 0
        self._arrays = (
            jnp.asarray(img.slots), jnp.asarray(img.vals), img.inline
        )
        self._uniq_host = None
        if img.inline and img.vals.size <= 0xFFFF:
            self._uniq_host = (
                np.asarray(img.vals) >> np.uint64(32)
            ).astype(np.uint32)
        self._n_distinct = img.n_distinct
        self._tax = tree.device_arrays()
        self._step_cache = {}
        import os as _os

        self.max_runs = int(_os.environ.get("BONSAI_TPU_MAX_RUNS", 8))
        self._overflow_batches = 0
        self._overflow_bump_after = 3
        return self

    # -- jitted device step ----------------------------------------------
    def _make_step(self, paired: bool = False, maxr: Optional[int] = None):
        """Two outputs per batch, both device-resident until fetched:

        * compact uint32 — taxon | counters | RLE of the hit-taxa stream
          (layout per build_step_outputs/dict_layout: 2-3 head words +
          width-adaptive run indices + packed run lengths).  The Kraken
          output only needs the RUN-LENGTH-ENCODED stream, so the RLE
          happens on device and the host fetches ~20 B/read.
        * full (R, 4 + ceil(W/32) + W) uint32 — the positional
          taxon | counters | hit-bitmask | per-kmer-taxa matrix, fetched
          only for batches where some read has more than MAXR runs (the
          reference's analog of one contiguous sam buffer per read,
          classifier.h:221).

        paired=True treats adjacent row pairs (2i, 2i+1) as mates of one
        read pair: hits of both mates merge into one resolve_tree call and
        one output row of width W = 2P (classify_seq's paired branch,
        classifier.h:236-240); hit runs spanning the mate boundary merge,
        as in the reference's single taxa vector."""
        import jax
        import jax.numpy as jnp

        table = self.db.table
        enc = self.enc
        tax = self._tax

        inline = self._arrays[2]
        maxr = self.max_runs if maxr is None else maxr
        dict16 = self._uniq_host is not None
        dict_size = len(self._uniq_host) if dict16 else None
        ndist = self._n_distinct

        def step(codes, lengths, slots, vals):
            em = enc.emissions(codes, lengths)
            kmers, valid = em.values, em.mask
            if dict16:
                packed, found, sel = table.probe_device(
                    kmers, arrays=(slots, vals, inline), want_idx=True
                )
                oidx = sel  # dictionary index, host maps back to taxid
            else:
                packed, found = table.probe_device(
                    kmers, arrays=(slots, vals, inline)
                )
                oidx = (packed >> jnp.uint64(32)).astype(jnp.uint32)
            cidx = (packed & jnp.uint64(0xFFFFFFFF)).astype(jnp.int32)
            hit = valid & found
            valid1 = valid.sum(axis=-1).astype(jnp.uint32)
            if paired:
                # merge mate rows: (B, P) -> (B/2, 2P); row-major reshape
                # concatenates mate1's positions then mate2's
                B, P = hit.shape
                hit = hit.reshape(B // 2, 2 * P)
                valid = valid.reshape(B // 2, 2 * P)
                cidx = cidx.reshape(B // 2, 2 * P)
                oidx = oidx.reshape(B // 2, 2 * P)
                valid1 = valid1[0::2]
            cidx = jnp.where(hit, cidx, 0)
            taxon_c = resolve_batch(cidx, hit, tax, n_distinct=ndist)
            taxon = tax["tax_ids"][taxon_c].astype(jnp.uint32)
            taxa = jnp.where(hit, oidx, 0).astype(jnp.uint32)
            return build_step_outputs(
                taxon, taxa, hit, valid, valid1, maxr, dict_size=dict_size
            )

        return jax.jit(step)

    def _make_step_packed(self, paired: bool = False,
                          maxr: Optional[int] = None,
                          with_n: str = "mask",
                          lproc: Optional[int] = None):
        """Same step, but reads arrive as 2-bit-packed u32 words plus an
        N-bitmask — 4.5x fewer bytes over the host->device link (the
        design rule: minimize host<->device transfers).  Unpacking is a
        few shifts fused into the encode.  with_n selects the
        ambiguity channel: "mask" (full bitmask), "sparse" (a short flat
        index list scattered on device — in-read Ns are rare in real
        read sets), or "none" (no channel at all).

        ``lproc`` slices the unpacked codes to the batch's (8-rounded)
        true max read length before the encoder, so the probe runs at
        P = lproc - c + 1 positions instead of the 32-aligned upload
        width's — for 101 bp reads in a 128-wide bucket that is 24% fewer
        row gathers, the step's dominant cost."""
        import jax

        body = self._make_step(paired, maxr)

        import jax.numpy as jnp

        def slice_cast(codes, lengths):
            if lproc is not None and lproc < codes.shape[1]:
                codes = codes[:, :lproc]
            # lengths may arrive u16 (2 B/read on the wire); the encoder
            # needs signed arithmetic
            return codes, lengths.astype(jnp.int32)

        if with_n == "mask":
            def step_packed(pcodes, nmask, lengths, slots, vals):
                codes, lengths = slice_cast(unpack_2bit(pcodes, nmask),
                                            lengths)
                return body(codes, lengths, slots, vals)
        elif with_n == "sparse":
            # rare in-read Ns arrive as a short list of flat (row*lproc +
            # col) positions (sentinel-padded); one tiny device scatter
            # replaces the full bitmask upload
            def step_packed(pcodes, nidx, lengths, slots, vals):
                codes, lengths = slice_cast(unpack_2bit(pcodes), lengths)
                B, L = codes.shape
                codes = (
                    codes.reshape(-1)
                    .at[nidx.astype(jnp.int32)]
                    .set(jnp.int8(-1), mode="drop")
                    .reshape(B, L)
                )
                return body(codes, lengths, slots, vals)
        else:
            def step_packed(pcodes, lengths, slots, vals):
                codes, lengths = slice_cast(unpack_2bit(pcodes), lengths)
                return body(codes, lengths, slots, vals)

        return jax.jit(step_packed)

    def _step(self, paired: bool = False, packed: bool = False,
              with_n: str = "mask", lproc: Optional[int] = None):
        """(compiled_fn, maxr) — the run capacity is cached WITH the
        function so the adaptive max_runs bump (writer thread) can never
        mismatch a compiled step against a different parse width: callers
        take both from one atomic tuple."""
        key = ("fn", paired, packed, with_n, lproc)
        maxr = self.max_runs
        ent = self._step_cache.get(key)
        if ent is None or ent[1] != maxr:
            fn = (
                self._make_step_packed(paired, maxr, with_n, lproc)
                if packed
                else self._make_step(paired, maxr)
            )
            ent = (fn, maxr)
            self._step_cache[key] = ent
        return ent

    # -- per-batch --------------------------------------------------------
    @staticmethod
    def _bucket_batch(n: int) -> int:
        """Round the read count up to a small bucket set so partial final
        batches reuse the compiled step instead of recompiling."""
        b = 256
        while b < n:
            b <<= 1
        return b

    def classify_batch(
        self, batch: fastx.ReadBatch, paired: bool = False,
        full: bool = False,
    ) -> BatchResult:
        """full=True forces the positional taxa/hit_mask fetch (tests and
        tools that need per-position hits; the CLI path uses the compact
        run-length fetch)."""
        return self._finish_batch(
            batch, self._dispatch_batch(batch, paired), paired, force_full=full
        )

    @staticmethod
    def pack_codes(codes: np.ndarray, with_nmask: bool = True):
        """(B, L) int8 codes (L % 32 == 0) -> (packed (B, L/16) u32 of
        2-bit codes, nmask (B, L/32) u32 ambiguity bits — or None when
        with_nmask=False, the no-N upload fast path)."""
        B, L = codes.shape
        v = np.where(codes < 0, 0, codes).astype(np.uint32).reshape(B, L // 16, 16)
        packed = np.bitwise_or.reduce(
            v << (np.arange(16, dtype=np.uint32) * 2), axis=-1
        )
        if not with_nmask:
            return packed, None
        nb = (codes < 0).astype(np.uint32).reshape(B, L // 32, 32)
        nmask = np.bitwise_or.reduce(
            nb << np.arange(32, dtype=np.uint32), axis=-1
        )
        return packed, nmask

    def _batch_multiple(self, paired: bool) -> int:
        """Row-count multiple the padded batch must satisfy (the sharded
        classifier overrides this with its mesh rank count)."""
        return 2 if paired else 1

    def _to_device(self, x):
        """Host batch array -> device (the sharded classifier overrides
        this for multi-process meshes)."""
        import jax.numpy as jnp

        return jnp.asarray(x)

    def _prepare_batch(self, batch: fastx.ReadBatch, paired: bool = False):
        """Host half of a dispatch: pad the batch to its pow2 bucket (and
        the paired/mesh multiple), 2-bit pack, and START the host->device
        upload.  Pure host + transfer work — safe to run in a producer
        thread so it overlaps the previous batch's dispatch.

        Reads cross the host->device link 2-bit packed (16 codes + their
        32 N-mask bits per pair of u32 words) — 4.5x smaller than int8
        codes; the batch dim pads to pow2 buckets and the length dim to a
        multiple of 32 so compiled steps are reused."""
        n = len(batch.names)
        Bp = self._bucket_batch(n)
        mult = self._batch_multiple(paired)
        if Bp % mult:
            Bp = ((Bp + mult - 1) // mult) * mult
        L = batch.codes.shape[1]
        Lp = (L + 31) & ~31
        # processing width: the batch's true max read length rounded up to
        # Lp/16 granularity (>= 8) — the device step slices the unpacked
        # codes here, and the upload ships only the covering 16-code
        # words, instead of both paying the 32-aligned bucket.  The
        # granularity bounds the compiled-shape set to <= 16 lproc values
        # per length bucket even for variable-length long-read sets
        maxlen = int(batch.lengths.max()) if n else 0
        g = max(8, Lp >> 4)
        lproc = min(Lp, max(-(-maxlen // g) * g, 8))
        w16 = (lproc + 15) // 16
        cap = max(64, Bp // 32)
        got = self._pack_batch_native(batch, n, Bp, L, lproc, w16, cap)
        if got is not None:
            pcodes, nmask, nidx, n_inread, lengths = got
        else:
            codes, lengths = batch.codes, batch.lengths
            if Bp != n or Lp != L:
                codes = np.full((Bp, Lp), -1, dtype=np.int8)
                codes[:n, :L] = batch.codes
                lengths = np.zeros(Bp, dtype=np.int32)
                lengths[:n] = batch.lengths
            # -1 codes are either in-read Ns or tail padding; padding
            # totals Bp*Lp - sum(lengths), so any excess negative count
            # means a real ambiguous base.  Build only the channel the
            # mode decision below will actually ship.
            n_neg = int((codes < 0).sum())
            n_inread = n_neg - (Bp * Lp - int(lengths.sum()))
            nidx = nmask = None
            use_sparse = (
                0 < n_inread <= cap and self._sparse_n_ok()
            )
            if use_sparse:
                inread = (codes < 0) & (
                    np.arange(Lp, dtype=np.int32) < lengths[:, None]
                )
                rr, cc = np.nonzero(inread)
                nidx = np.full(cap, 0x7FFFFFFF, dtype=np.uint32)
                nidx[: rr.size] = (rr * lproc + cc).astype(np.uint32)
            pcodes, nmask = self.pack_codes(
                codes, with_nmask=n_inread > 0 and not use_sparse
            )
            pcodes = np.ascontiguousarray(pcodes[:, :w16])
            if nmask is not None:
                nmask = np.ascontiguousarray(nmask[:, : (w16 + 1) // 2])
        if n_inread == 0:
            nmode, naux = "none", None
        elif self._sparse_n_ok() and n_inread <= cap:
            # rare Ns: ship flat positions, scatter -1 on device
            nmode, naux = "sparse", nidx
        else:
            nmode, naux = "mask", nmask
        if maxlen <= 0xFFFF:
            lengths = lengths.astype(np.uint16)  # halve the lengths upload
        return (
            self._to_device(pcodes),
            self._to_device(naux) if naux is not None else None,
            self._to_device(lengths),
            lproc,
            nmode,
        )

    def _pack_batch_native(self, batch, n, Bp, L, lproc, w16, cap):
        """One-pass C pad+pack+N-extract (native/src/pack.cpp); None when
        the native library is unavailable (numpy fallback above)."""
        from .. import native

        lib = native.get_lib()
        if lib is None or not hasattr(lib, "btpu_pack_batch"):
            return None
        codes = np.ascontiguousarray(batch.codes, dtype=np.int8)
        lens_in = np.ascontiguousarray(batch.lengths, dtype=np.int32)
        nmw = (w16 + 1) // 2
        pcodes = np.empty((Bp, w16), dtype=np.uint32)
        nmask = np.empty((Bp, nmw), dtype=np.uint32)
        nidx = np.empty(cap, dtype=np.uint32)
        n_inread = lib.btpu_pack_batch(
            codes.ctypes.data, n, L, lens_in.ctypes.data, Bp, w16, lproc,
            pcodes.ctypes.data, nmask.ctypes.data, nmw,
            nidx.ctypes.data, cap,
        )
        lengths = np.zeros(Bp, dtype=np.int32)
        lengths[:n] = lens_in
        return pcodes, nmask, nidx, int(n_inread), lengths

    def _sparse_n_ok(self) -> bool:
        """Sparse-N scatter uses batch-global flat indices, valid only
        when the batch is not row-sharded across devices (the sharded
        classifier overrides this)."""
        return True

    def _dispatch_prepared(self, prep, paired: bool = False):
        """Device half: run the compact step on prepared inputs and start
        the device->host copy of the compact matrix (it enqueues behind
        the computation, so the transfer overlaps later batches' compute
        instead of serializing inside the writer thread's np.asarray)."""
        pcodes, naux, lengths, lproc, nmode = prep
        step, maxr = self._step(
            paired, packed=True, with_n=nmode, lproc=lproc
        )
        if naux is None:
            compact, full = step(
                pcodes, lengths, self._arrays[0], self._arrays[1]
            )
        else:
            compact, full = step(
                pcodes, naux, lengths, self._arrays[0], self._arrays[1]
            )
        try:
            compact.copy_to_host_async()
        except (AttributeError, NotImplementedError):
            pass
        # max_runs may be bumped between dispatch and finish (adaptive
        # overflow handling under pipelining): the in-flight output carries
        # the SAME maxr the compiled step was built with (atomic tuple)
        return compact, full, lproc, maxr

    def _dispatch_batch(self, batch: fastx.ReadBatch, paired: bool = False):
        return self._dispatch_prepared(
            self._prepare_batch(batch, paired), paired
        )

    def _finish_batch(
        self, batch: fastx.ReadBatch, out, paired: bool = False,
        force_full: bool = False,
    ) -> BatchResult:
        n = len(batch.names)
        R = n // 2 if paired else n
        compact_dev, full_dev, Lp, maxr = out
        # fetch the (much smaller) compact matrix in one transfer; trim on
        # host (a device-side out[:n] would compile a fresh slice op per
        # batch size).  The full positional matrix stays on device unless
        # some read overflows the run capacity.
        cm = np.asarray(compact_dev)[:R]
        return self._finish_arrays(
            batch, cm, lambda: np.asarray(full_dev)[:R], Lp, maxr,
            paired, force_full,
        )

    def _finish_arrays(
        self, batch: fastx.ReadBatch, cm: np.ndarray, fetch_full,
        Lp: int, maxr: int, paired: bool = False,
        force_full: bool = False, allow_bump: bool = True,
    ) -> BatchResult:
        """Decode a (row-matched) compact matrix + batch slice into a
        BatchResult.  ``fetch_full`` lazily returns the row-matched full
        positional matrix (only called on run-capacity overflow).  The
        distributed per-rank pipeline feeds LOCAL device shards here;
        allow_bump=False there keeps the compiled-step choice identical
        across processes (a per-process max_runs bump would diverge the
        traced collectives)."""
        n = len(batch.names)
        R = n // 2 if paired else n
        P_pad = max(Lp - self.sp.c + 1, 0)
        W_pad = 2 * P_pad if paired else P_pad
        uniq = getattr(self, "_uniq_host", None)
        dict16 = uniq is not None

        def unpackbits(words, vb, count):
            per = 32 // vb
            mask = (1 << vb) - 1
            out = np.empty((cm.shape[0], per * words.shape[1]), np.uint32)
            for j in range(per):
                out[:, j::per] = (words >> (vb * j)) & mask
            return out[:, :count]

        if W_pad < (1 << 15):
            # packed layouts (see build_step_outputs / dict_layout)
            taxon = cm[:, 0]
            if dict16:
                vb, lb, head_words = dict_layout(int(uniq.size), W_pad)
            else:
                vb = lb = None
                head_words = 3
            if dict16 and head_words == 2:
                h1 = cm[:, 1]
                n_missing = (h1 & 0xFF).astype(np.int32)
                n_kmers = ((h1 >> 8) & 0xFF).astype(np.int32)
                n_kmers1 = ((h1 >> 16) & 0xFF).astype(np.int32)
                n_runs = h1 >> 24
                off = 2
            else:
                n_missing = (cm[:, 1] & 0xFFFF).astype(np.int32)
                n_kmers = (cm[:, 1] >> 16).astype(np.int32)
                n_kmers1 = (cm[:, 2] & 0xFFFF).astype(np.int32)
                n_runs = cm[:, 2] >> 16
                off = 3
            if dict16:
                nv = -(-maxr // (32 // vb))
                rv = unpackbits(cm[:, off : off + nv], vb, maxr)
                nl = -(-maxr // (32 // lb))
                rl = unpackbits(cm[:, off + nv : off + nv + nl], lb, maxr)
            else:
                rv = cm[:, off : off + maxr]
                rl = unpackbits(
                    cm[:, off + maxr : off + maxr + (maxr + 1) // 2], 16,
                    maxr,
                )
        else:
            taxon = cm[:, 0]
            n_missing = cm[:, 1].astype(np.int32)
            n_kmers = cm[:, 2].astype(np.int32)
            n_kmers1 = cm[:, 3].astype(np.int32)
            n_runs = cm[:, 4]
            rv = cm[:, 5 : 5 + maxr]
            rl = cm[:, 5 + maxr : 5 + 2 * maxr]
        if dict16:
            # run values are dictionary indices: map back to taxids (unused
            # slots past n_runs decode to uniq[0]; never read)
            rv = uniq[np.minimum(rv, np.uint32(uniq.size - 1))]
        taxa = hit = run_vals = run_lens = None
        overflowed = bool(n_runs.size and int(n_runs.max()) > maxr)
        if overflowed and not force_full and allow_bump:
            # run-rich dataset: after a few full-matrix fallbacks, double
            # the device-side run capacity (one recompile) so later
            # batches go back to the small compact fetch
            self._overflow_batches += 1
            if (
                self._overflow_batches >= self._overflow_bump_after
                and self.max_runs < 64
            ):
                # runs in the WRITER thread while the main thread may be
                # dispatching: safe — _step caches (fn, maxr) tuples, so a
                # dispatch either sees the old pair or rebuilds with the
                # new capacity; every in-flight output carries the maxr of
                # the step that produced it
                self.max_runs = self.max_runs * 2
                self._overflow_batches = 0
        if force_full or overflowed:
            # rare: some read has > maxr runs; fetch the positional matrix
            P = Lp - self.sp.c + 1
            P = max(P, 0)
            W = 2 * P if paired else P
            hb = (W + 31) // 32
            fm = fetch_full()
            hit_words = fm[:, 4 : 4 + hb]
            taxa = fm[:, 4 + hb :]
            if W:
                shifts = np.arange(32, dtype=np.uint32)
                hit = (
                    (hit_words[:, :, None] >> shifts) & np.uint32(1)
                ).astype(bool).reshape(R, hb * 32)[:, :W]
            else:
                hit = np.zeros((R, 0), dtype=bool)
            # trim the length-padding columns (always miss positions) so
            # positional results match the caller's un-padded read width
            Pt = max(batch.codes.shape[1] - self.sp.c + 1, 0)
            Wt = 2 * Pt if paired else Pt
            if Wt < W:
                if paired:
                    # padded layout is [mate1 P | mate2 P]; keep Pt of each
                    taxa = np.concatenate(
                        [taxa[:, :Pt], taxa[:, P : P + Pt]], axis=1
                    )
                    hit = np.concatenate(
                        [hit[:, :Pt], hit[:, P : P + Pt]], axis=1
                    )
                else:
                    taxa = taxa[:, :Wt]
                    hit = hit[:, :Wt]
            if dict16:
                # full-matrix taxa are dictionary indices too
                taxa = np.where(
                    hit, uniq[np.minimum(taxa, np.uint32(uniq.size - 1))], 0
                ).astype(np.uint32)
        else:
            run_vals = rv
            run_lens = rl
            n_runs = n_runs.astype(np.int32)
        self.n_classified += int((taxon != 0).sum())
        self.n_unclassified += int((taxon == 0).sum())
        common = dict(
            taxon=taxon,
            taxa=taxa,
            hit_mask=hit,
            n_missing=n_missing,
            n_kmers=n_kmers,
            n_kmers1=n_kmers1,
            run_vals=run_vals,
            run_lens=run_lens,
            n_runs=None if run_vals is None else n_runs,
        )
        if paired:
            return BatchResult(
                names=batch.names[0::2],
                seqs=batch.seqs[0::2],
                quals=batch.quals[0::2] if batch.quals else None,
                lengths=batch.lengths[0::2],
                lengths2=batch.lengths[1::2],
                seqs2=batch.seqs[1::2],
                quals2=batch.quals[1::2] if batch.quals else None,
                **common,
            )
        return BatchResult(
            names=batch.names,
            seqs=batch.seqs,
            quals=batch.quals,
            lengths=batch.lengths,
            **common,
        )

    # -- full dataset ------------------------------------------------------
    def process_dataset(
        self,
        path: str,
        out_fh,
        mate_path: Optional[str] = None,
        batch_size: int = 4096,
        profile: bool = False,
    ):
        """Classify a FASTA/FASTQ file (optionally paired) and write text
        output (process_dataset, classifier.h:296-337).

        Three-stage pipeline: a PRODUCER thread parses, pads, 2-bit packs,
        and uploads batches; the MAIN thread dispatches the device step
        (keeping several batches in flight); a WRITER thread materializes
        results and formats/writes text.  Device compute, both transfer
        directions, and host parse/format all overlap (the reference
        overlaps via its kt_forpool thread pool; here JAX's async dispatch
        + two pipeline threads give the same shape).  Output order is
        preserved by the queues.

        With profile=True, per-stage wall times (parse / dispatch /
        materialize / format) accumulate in self.stage_seconds and print to
        stderr at the end (TIME_CODE-style observability, SURVEY §5)."""
        import os as _os
        import queue as _queue
        import threading as _threading
        import time as _time

        is_paired = mate_path is not None
        if is_paired and batch_size % 2:
            batch_size += 1  # pairs must not straddle batches
        self.stage_seconds = {
            "parse": 0.0, "dispatch": 0.0, "materialize": 0.0, "format": 0.0,
        }
        stats = self.stage_seconds
        t = _time.perf_counter
        it = iter(fastx.batch_reads(
            path, self.lut, batch_size=batch_size, mate_path=mate_path
        ))
        n_reads = 0
        t_all = t()
        depth = int(_os.environ.get("BONSAI_TPU_PIPELINE_DEPTH", 4))
        q: _queue.Queue = _queue.Queue(maxsize=depth)
        pq: _queue.Queue = _queue.Queue(maxsize=depth)
        err: list = []
        perr: list = []
        stop: list = []

        def producer():
            try:
                for batch in it:
                    if stop:
                        break
                    t0 = t()
                    prep = self._prepare_batch(batch, is_paired)
                    stats["parse"] += t() - t0
                    pq.put((batch, prep))
            except BaseException as e:
                perr.append(e)
            finally:
                pq.put(None)

        def writer():
            try:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    self._write_result(out_fh, *item, is_paired)
            except BaseException as e:  # surface in the main thread
                err.append(e)
                while q.get() is not None:  # drain so producer unblocks
                    pass

        pt = _threading.Thread(target=producer, daemon=True)
        wt = _threading.Thread(target=writer, daemon=True)
        pt.start()
        wt.start()
        producer_done = False
        try:
            while True:
                item = pq.get()
                if item is None:
                    producer_done = True
                    break
                if err:
                    raise err[0]
                batch, prep = item
                n_reads += len(batch.names)
                t0 = t()
                out = self._dispatch_prepared(prep, is_paired)
                stats["dispatch"] += t() - t0
                q.put((batch, out))
        finally:
            stop.append(True)
            while not producer_done:  # unblock + retire the producer
                producer_done = pq.get() is None
            pt.join()
            q.put(None)
            wt.join()
        if err:
            raise err[0]
        if perr:
            raise perr[0]
        if profile:
            total = t() - t_all
            import sys as _sys

            parts = "  ".join(
                f"{k}={v:.3f}s" for k, v in stats.items()
            )
            print(
                f"# profile: {n_reads} reads in {total:.3f}s "
                f"({n_reads / max(total, 1e-9):,.0f} reads/s)  {parts}",
                file=_sys.stderr,
            )

    def _write_result(self, out_fh, batch, out, is_paired):
        import time as _time

        stats = getattr(self, "stage_seconds", None)
        t = _time.perf_counter
        t0 = t()
        res = self._finish_batch(batch, out, is_paired)
        if stats is not None:
            stats["materialize"] += t() - t0
            t0 = t()
        text = out_mod.format_batch(
            res,
            self.sp.c,
            emit_all=self.emit_all,
            emit_kraken=self.emit_kraken,
            emit_fastq=self.emit_fastq,
        )
        out_fh.write(text)
        if stats is not None:
            stats["format"] += t() - t0

    def classify_reads(self, seqs: List[bytes]) -> np.ndarray:
        """Convenience: classify raw sequences -> original taxids."""
        maxlen = max(len(s) for s in seqs)
        L = fastx._bucket_len(maxlen)
        codes = np.full((len(seqs), L), -1, dtype=np.int8)
        lengths = np.empty(len(seqs), dtype=np.int32)
        for i, s in enumerate(seqs):
            codes[i, : len(s)] = self.lut[np.frombuffer(s, dtype=np.uint8)]
            lengths[i] = len(s)
        batch = fastx.ReadBatch(
            names=[b""] * len(seqs), seqs=seqs, codes=codes, lengths=lengths,
            quals=[None] * len(seqs),
        )
        return self.classify_batch(batch).taxon
