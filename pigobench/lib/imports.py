"""The JAX side must stay out of a run: neither JAX nor the JAX package.

Modules are compared by their top-level name, the part before the first
dot, whole: `pigo_tpu_torch` is the port and allowed, `pigo_tpu` and
`pigo_tpu.models` are the JAX package and refused.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pigo_tpu"})


def forbidden(names) -> list[str]:
    """The names among `names` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded_forbidden() -> list[str]:
    return forbidden(list(sys.modules))
