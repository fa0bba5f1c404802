"""Frozen dataclasses that are JAX pytrees.

The problem containers, solver states and sharded layouts are immutable
records of arrays plus a few static settings (camera model, robust
kernel).  This module makes such a record a pytree with the standard
library and :func:`jax.tree_util.register_dataclass`:

- array fields are children, in declaration order;
- fields declared with ``field(pytree_node=False)`` are static: they live
  in the treedef, so changing one retraces a jitted function instead of
  being traced;
- ``.replace(**changes)`` returns a copy with some fields swapped.

Usage::

    @struct.dataclass
    class Problem:
        X: jnp.ndarray
        model: str = struct.field(pytree_node=False, default="pose")

    class State(struct.PyTreeNode):   # subclasses are dataclasses too
        x: jnp.ndarray
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

_T = TypeVar("_T")


def field(pytree_node: bool = True, **kwargs) -> Any:
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls: type[_T]) -> type[_T]:
    """Turn ``cls`` into a frozen dataclass registered as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls


class PyTreeNode:
    """Base class: every subclass becomes a :func:`dataclass` pytree."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclass(cls)
