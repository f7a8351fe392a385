"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (``bench.py``, ``chip_smoke.py`` and the
tools): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here sets another directory; otherwise the cache lives at one
fixed path inside the checkout, ``<repo>/.jax_cache`` (listed in
``.gitignore``), so that a later run of the same checkout finds it again.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["DEFAULT_CACHE_DIR", "configure_compile_cache"]

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at the directory the rule
    above names, and return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env)
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return DEFAULT_CACHE_DIR
