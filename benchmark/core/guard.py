"""The modules the benchmark's process must never load: JAX, its libraries
and the JAX package, compared by whole top-level names (the port's name,
`egonn_tpu_torch`, begins with the JAX package's)."""
from __future__ import annotations

from typing import Iterable, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "egonn_tpu"})


def forbidden_modules(names: Iterable[str], forbidden=FORBIDDEN) -> Set[str]:
    return {n for n in names if n.split(".", 1)[0] in forbidden}
