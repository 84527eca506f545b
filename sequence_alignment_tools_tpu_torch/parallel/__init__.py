"""Mesh sharding, multi-process bring-up, and out-of-process host tails.

Lazy re-exports (PEP 562), as the JAX package's ``parallel/__init__.py``
has them: importing the package loads neither ``shard`` nor the scanners
it imports.
"""

_SHARD_EXPORTS = ("make_mesh", "sharded_scan_counts", "shard_codes")


def __getattr__(name):
    if name in _SHARD_EXPORTS:
        from . import shard

        return getattr(shard, name)
    raise AttributeError(name)
