"""bonsai-tpu: an accelerator-native metagenomics / taxonomic-classification
framework, run on NVIDIA GPUs through JAX.

A ground-up JAX/XLA re-design of the capabilities of dnbaker/bonsai
(reference: /root/reference): k-mer encoders (contiguous, spaced, windowed /
minimized, rolling-hash), k-mer -> LCA-taxid database construction, a
Kraken-style exact-k-mer classifier, NCBI-taxonomy utilities, sketching
(HyperLogLog / SetSketch) and taxonomy-restructuring tools.

Architecture (accelerator-first, not a port):
  * per-read inner loops  -> batched static-shape jnp ops
  * khash k-mer->taxid DB -> bucketized open-addressing table in device memory,
                             probed by vectorized row gathers
  * thread pools          -> data-parallel pjit/shard_map over a device mesh
  * taxonomy pointer-walks-> dense parent/depth arrays + Euler-tour interval
                             labels (ancestor tests become rank comparisons)
"""

from . import config as _config  # noqa: F401  (enables x64 before anything else)

__version__ = "0.1.0"

from .core.spacer import Spacer, parse_spacing  # noqa: E402
from .taxonomy.tree import TaxTree  # noqa: E402

__all__ = [
    "Spacer",
    "parse_spacing",
    "TaxTree",
    "__version__",
]
