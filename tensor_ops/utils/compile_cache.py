"""Where JAX keeps its persistent compilation cache for this checkout.

Entry points (``apps/*.py``, ``bench.py``, ``chip_smoke.py``) call
:func:`use_compile_cache` once before their first compile; importing the
library never touches the setting.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: The checkout's own cache directory (listed in ``.gitignore``).  A fixed
#: path: the cache is keyed by it, so a directory that moved would never
#: hit.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def use_compile_cache() -> str:
    """Return the directory JAX caches compiled programs in.  When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no other
    directory is set; otherwise the cache goes to
    :data:`CHECKOUT_CACHE_DIR`."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
