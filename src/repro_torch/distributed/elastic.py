"""Elastic scaling: restore checkpoints across changed meshes.

The JAX package's ``distributed/elastic.py``.  Checkpoints store host
arrays, and the model's *logical* axes (its ``ParamSpec`` tree) re-derive
the shardings on whatever mesh the relaunched job has
(``Sharder.param_sharding``), so one checkpoint restores onto any mesh
shape; ``Sharder``'s divisibility fallback covers shrunken axes.  Every
rank reads the host array and keeps its own block as a ``DTensor``
(``TensorSharding.distribute``), so the restore runs no collective.
"""

from __future__ import annotations

from ..models.module import spec_tree_map
from .sharding import Sharder

__all__ = ["shardings_for_specs", "elastic_restore"]


def shardings_for_specs(specs, sharder: Sharder):
    """The ``TensorSharding`` tree of a ParamSpec tree on the sharder's
    mesh."""
    return spec_tree_map(sharder.param_sharding, specs)


def elastic_restore(manager, specs, sharder: Sharder, template,
                    step: int | None = None):
    """Restore ``template``-shaped state re-sharded for ``sharder``'s mesh.

    ``specs`` must mirror ``template``'s tree (ParamSpec leaves) -- for
    optimizer state, map the param specs through the state structure first.
    """
    shardings = shardings_for_specs(specs, sharder) \
        if sharder.mesh is not None else None
    return manager.restore(template, step=step, shardings=shardings)
