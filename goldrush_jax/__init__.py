"""goldrush-jax: long-read de novo assembly framework in JAX.

A from-scratch JAX/XLA implementation of the GoldRush golden-path
algorithm and its downstream pipeline stages.  64-bit integer support is
required for ntHash values, so x64 mode is enabled at import.

The platform is JAX's own choice (``JAX_PLATFORMS`` selects it).  The
persistent compilation cache lives where ``JAX_COMPILATION_CACHE_DIR``
says; when that is unset it sits at ``<checkout>/.jax_cache``, a fixed
path, so reruns of one checkout start hot (the engine compiles one
executable per (batch, tile-bucket) shape)."""

import os

import jax

jax.config.update("jax_enable_x64", True)

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

__version__ = "0.1.0"
