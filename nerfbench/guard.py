"""The import guard: no module of the JAX stack or of the JAX package.

A module counts by its whole top-level name, the part before the first dot,
so `hashnerf_torch` never matches `hashnerf_tpu`.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hashnerf_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (default: sys.modules) whose top-level name is
    forbidden, sorted."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(when: str) -> None:
    """Raise SystemExit(3), naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"nerfbench: {when}: forbidden modules loaded: {', '.join(found[:20])}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
