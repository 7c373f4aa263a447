"""chip_smoke.py, the device helpers and the compile-cache placement.

The phase functions run here at tiny sizes on the CPU; the script as a
whole must refuse the CPU.  `test_small_phases_on_gpu` runs phases 2-3 at
small size on a card and skips elsewhere.
"""

import json
import os
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_compilation_cache_dir_env_wins():
    from bonsai_tpu import config

    assert config.compilation_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere"}
    ) is None


def test_compilation_cache_dir_fixed_checkout_path():
    import jax

    from bonsai_tpu import config

    want = os.path.join(REPO, ".jax_cache")
    assert config.compilation_cache_dir({}) == want
    assert config.REPO_CACHE_DIR == want
    # this process: the environment's directory if it names one, else ours
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    assert jax.config.jax_compilation_cache_dir == (env or want)


def test_require_gpu_refuses_cpu():
    from bonsai_tpu.device import require_gpu

    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        require_gpu()
    fake = [types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")]
    assert require_gpu(fake) is fake


def test_card_identity(monkeypatch):
    from bonsai_tpu import device

    monkeypatch.setattr(device, "NVIDIA_SMI_QUERY",
                        ["echo", "NVIDIA H100 80GB HBM3, 700.00 W"])
    assert device.card_identity() == "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(device, "NVIDIA_SMI_QUERY",
                        [os.path.join(REPO, "no-such-nvidia-smi")])
    assert device.card_identity() is None
    monkeypatch.setattr(device, "NVIDIA_SMI_QUERY", ["false"])
    assert device.card_identity() is None


def test_phase_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cs.phase_device()


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_fails_without_card_and_prints_no_result(argv, capsys):
    assert cs.main(argv) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "FAILED in phase device" in err


def _tiny_corpus(tmp_path, n_genomes=3, mb=0.02):
    sb = cs._scale_bench()
    paths = sb.gen(n_genomes, mb, out_dir=str(tmp_path / "scale"), seed=3)
    return sb, paths


def test_scale_reads_match_their_construction(tmp_path):
    _, paths = _tiny_corpus(tmp_path)
    reads = str(tmp_path / "reads.fa")
    want = cs.make_scale_reads(paths, 500, reads, seed=4)
    assert want.shape == (500,)
    assert int((want == 0).sum()) == 100  # 20% random reads
    assert set(np.unique(want[want > 0])) <= {10, 11, 12}
    # every genome read is an exact slice of its genome (either strand)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    genomes = []
    for p in paths:
        with open(p, "rb") as fh:
            fh.readline()
            genomes.append(fh.read().replace(b"\n", b""))
    with open(reads, "rb") as fh:
        lines = fh.read().split(b"\n")
    for i in range(500):
        assert lines[2 * i] == b">r%d" % i
        seq = lines[2 * i + 1]
        assert len(seq) == 101
        if want[i]:
            g = genomes[want[i] - 10]
            assert seq in g or seq.translate(comp)[::-1] in g


def test_check_scale_output_catches_a_wrong_taxid(tmp_path):
    want = np.array([11, 0, 12])
    out = tmp_path / "out.tsv"
    out.write_bytes(b"C\tr0\t11\t101\t\nU\tr1\t0\t101\t\nC\tr2\t12\t101\t\n")
    cs.check_scale_output(str(out), want)
    out.write_bytes(b"C\tr0\t11\t101\t\nU\tr1\t0\t101\t\nC\tr2\t2\t101\t\n")
    with pytest.raises(AssertionError, match="1/3 reads disagree"):
        cs.check_scale_output(str(out), want)


def test_phase_scale_tiny(tmp_path, capsys):
    rows = cs.phase_scale(str(tmp_path), "cpu", n_genomes=3, mb=0.02,
                          n_reads=1000, probe_sizes=(0.01,))
    assert [r["keys_m"] for r in rows] == [0.01]
    assert rows[0]["ns_per_probe"] > 0
    out = capsys.readouterr().out
    assert "scale: 1000 reads == construction (800 genome, 200 random)" in out


def test_write_scale_taxonomy(tmp_path):
    from bonsai_tpu.taxonomy.ncbi import parse_nameid_map
    from bonsai_tpu.taxonomy.tree import TaxTree

    paths = [str(tmp_path / f"SYN_{i:04d}.fa") for i in range(3)]
    nodes, nameid = cs.write_scale_taxonomy(paths, str(tmp_path))
    tree = TaxTree.from_nodes_dmp(nodes)
    assert tree.lca(10, 12) == 2
    assert parse_nameid_map(nameid) == {
        "SYN_0000.1": 10, "SYN_0001.1": 11, "SYN_0002.1": 12,
    }


def test_lex25_goldens_from_btpu_and_image(tmp_path):
    work = str(tmp_path)
    lex = cs.build_lex25(work)
    img = os.path.join(work, "lex25.image")
    cs.cli("probe-image", lex, cs.GOLD_NODES, img)
    for src in (lex, img):
        cs.classify_against_golden(src, "classify_pe.tsv.gz",
                                   os.path.join(work, "pe.tsv"))
    with pytest.raises(AssertionError, match="diverges"):
        cs.classify_against_golden(lex, "classify_se_noall.tsv.gz",
                                   os.path.join(work, "se.tsv"), "-a")


def _small_phases(work, plane_prefix):
    """Phases 2-3 at small size: the lex_k25 golden DB, a traced classify
    equal to its golden, and the compiled packed step."""
    lex = cs.build_lex25(work)
    se = os.path.join(work, "se.tsv")
    tdir = os.path.join(work, "trace")
    cs.classify_against_golden(lex, "classify_se.tsv.gz", se,
                               "--trace-dir", tdir)
    planes = cs.summarize_trace(tdir, plane_prefix)
    assert planes and all(ops for _, _, ops in planes)
    rps = cs.phase_compile(lex, cs.GOLD_NODES,
                           os.path.join(cs.GOLD, "reads.fa"), se, "test",
                           steps=2, batch_size=256)
    assert rps > 0


def test_small_phases_on_cpu(tmp_path, capsys):
    _small_phases(str(tmp_path), "/host:CPU")
    out = capsys.readouterr().out
    assert "optimized HLO op counts: gather" in out
    assert "reading device_step_reads_per_s" in out


@pytest.mark.gpu
def test_small_phases_on_gpu(gpu_device, tmp_path):
    _small_phases(str(tmp_path), "/device:")


def test_entropy_scores_match_on_this_backend():
    assert cs.entropy_scores_match(rows=64, L=80, k=13) == 64 * 68


def test_entropy_value_is_table_exact():
    """H from the host table, added in code order, equals numpy's
    p*log(p) summed the same way, bit for bit, under jit."""
    import jax

    from bonsai_tpu.core import entropy

    k = 31
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, (32, 120)).astype(np.int8)
    counts = entropy.window_code_counts(codes, k, 4)
    p = counts / float(k)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(counts > 0, p * np.log(p), 0.0)
    want = ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]
    np.testing.assert_array_equal(entropy.entropy_value(counts, k), want)
    got = jax.jit(lambda c: entropy.entropy_value(c, k))(counts)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_summarize_trace_needs_a_trace(tmp_path):
    with pytest.raises(AssertionError, match="no trace written"):
        cs.summarize_trace(str(tmp_path))


def test_manifest_readings_are_labelled(capsys):
    cs.reading("NVIDIA H100 80GB HBM3, 700.00 W", "x", 1.5, "s")
    line = capsys.readouterr().out.strip()
    assert line.endswith("] reading x = 1.5 s  [NVIDIA H100 80GB HBM3, 700.00 W]")
    assert json.loads(json.dumps(cs._manifest()))["kraken"]["k"] == 31
