"""Global JAX configuration for bonsai-tpu.

k-mers are 64-bit packed integers (2 bits/base, k <= 32).  We enable x64 so
jnp.uint64 is a first-class dtype; XLA lowers 64-bit integer ops onto
32-bit instructions on accelerators that lack native 64-bit integer units.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: repeated CLI invocations (classify runs are
# one process per dataset, like the reference binaries) skip recompiling the
# classify step.  JAX_COMPILATION_CACHE_DIR, when set, is read by JAX itself
# and wins; otherwise the cache lives at one fixed path in the checkout (the
# path is part of the cache key, so it must not move between runs).
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir(environ=os.environ):
    """The cache directory this package sets, or None when the environment
    already names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


_cache_dir = compilation_cache_dir()
if _cache_dir is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
