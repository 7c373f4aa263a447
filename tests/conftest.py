import os

# Tests run on a virtual 8-device CPU mesh (multi-device sharding is
# validated without accelerator hardware).  `JAX_PLATFORMS=cuda python -m
# pytest -m gpu` overrides the platform to run the card-only tests.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


PHIX = os.path.join(os.path.dirname(__file__), "data", "phix.fa")
REF_PHIX = "/root/reference/test/phix.fa"


@pytest.fixture(scope="session")
def phix_seq() -> bytes:
    path = PHIX if os.path.exists(PHIX) else REF_PHIX
    seq = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith(">"):
                seq.append(line.strip())
    return "".join(seq).encode()


def random_dna(rng, n, n_prob=0.0) -> bytes:
    bases = np.array(list(b"ACGTN"), dtype=np.uint8)
    probs = np.array([1, 1, 1, 1, 0], dtype=np.float64)
    probs = probs / probs.sum() * (1 - n_prob)
    probs[4] = n_prob
    idx = rng.choice(5, size=n, p=probs)
    return bases[idx].tobytes()


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where JAX sees none (decided
    here, at run time, never at import or collection)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a CUDA device; JAX sees {devs[0].platform}")
    return devs[0]


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running scale/golden-replay tests; deselect with "
        "`-m 'not slow'` for the fast loop (the full tier runs in the "
        "verify drive)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips elsewhere.  Run them on the card "
        "with `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`",
    )
