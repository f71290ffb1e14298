"""Persistent XLA compilation cache for the command-line entry points.

``chip_smoke.py`` and ``bench.py`` call :func:`configure_compilation_cache`
before their first compile; library code never does. The cache directory
is part of what JAX keys a cached program on, so it is a fixed path:

- ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself, and this
  module sets nothing else);
- otherwise ``<repo>/.jax_cache`` next to the package (gitignored).
"""

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir(environ=None):
    """The directory the persistent cache should use under ``environ``."""
    environ = os.environ if environ is None else environ
    return environ.get(_ENV) or DEFAULT_DIR


def configure_compilation_cache(environ=None):
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir`; returns the directory."""
    import jax

    environ = os.environ if environ is None else environ
    path = compilation_cache_dir(environ)
    if not environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
