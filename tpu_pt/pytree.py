"""Frozen dataclasses registered as JAX pytrees.

``@pytree.dataclass`` makes a frozen dataclass whose fields are pytree
children, except those declared with :func:`static_field`: those are
metadata, part of the treedef, so they stay Python values under ``jit``
and a change of them selects another compiled executable. Instances get
``.replace(**changes)``.
"""

from __future__ import annotations

import dataclasses

import jax

_STATIC = "tpu_pt_static"


def static_field(**kwargs):
    """A dataclass field kept out of the pytree's leaves (hashable)."""
    return dataclasses.field(metadata={_STATIC: True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get(_STATIC)]
    data = [f.name for f in fields if not f.metadata.get(_STATIC)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
