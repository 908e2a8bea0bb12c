"""Where the hand-written kernels are built, shared by every launcher —
the port of ``repro/launch/compile_cache.py``.

The reference points JAX's persistent compilation cache at a directory.
The port's one compile is ``nvcc`` of the kernels' sources
(``kernels/build.py``), whose libraries are named by the hash of their
source and flags. ``--compile-cache DIR`` (or ``REPRO_COMPILE_CACHE=DIR``)
makes DIR the build directory, so a second process launch on the same
DIR finds every library and compiles nothing (its ``kernels/build`` span
has ``built`` empty). Without either, the build directory stays
``build/torch_ext/`` at the root of the checkout.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_VAR = "REPRO_COMPILE_CACHE"


def enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Build the kernels in ``path`` (or $REPRO_COMPILE_CACHE). Returns the
    absolute directory, or None if neither is set. Must run before the
    first build; safe to call more than once."""
    path = path or os.environ.get(ENV_VAR) or None
    if not path:
        return None
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    from repro_torch.kernels import build
    build.BUILD_DIR = Path(path)
    return path


def add_compile_cache_arg(parser) -> None:
    parser.add_argument("--compile-cache", default=None, metavar="DIR",
                        help="build directory of the CUDA kernels, kept "
                             f"across launches (default: ${ENV_VAR} if "
                             "set, else build/torch_ext/)")
