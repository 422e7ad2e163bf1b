"""Two ways the port's parity tests keep the JAX package's compiles in check.

The JAX package compiles a metric's jitted update and compute per instance, so a fresh JAX reference per test
case pays a compile for every case even where the inputs keep one shape. ``jax_metric(cls, **kwargs)`` hands out
one instance per class and constructor arguments, ``reset()`` before each reuse: the cases that share a
configuration share its compiled programs, and each still feeds the same inputs to the port and to JAX and
compares the same values. Use it only where the test drives the JAX instance through ``update``, ``forward`` and
``compute`` and changes nothing else on it.

``jax_op_by_op``, imported into a test module, runs each of its tests under ``jax.disable_jit()``: the JAX side
evaluates the same functions op by op, and each primitive's program is compiled once per shape for the whole
process, where a jitted call of a new configuration compiles its whole program. It pays in files whose cases are
each a configuration of their own, and is a no-op where JAX is not installed (the machine with the card). The JAX
package branches on ``is_traced`` for its host-side checks, so each such module names in ``JAX_JITTED_CASES`` at
least one case that keeps JAX's jit on: the port is held to JAX's traced branches there too.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import pytest

_POOL: Dict[Tuple, Any] = {}


class _Identity:
    """An unhashable argument, keyed (and kept alive) by identity."""

    __slots__ = ("obj",)

    def __init__(self, obj: Any) -> None:
        self.obj = obj

    def __hash__(self) -> int:
        return id(self.obj)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, _Identity) and other.obj is self.obj


def _key(value: Any) -> Any:
    if isinstance(value, dict):
        return ("dict", tuple(sorted((k, _key(v)) for k, v in value.items())))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(_key(v) for v in value))
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tobytes())
    try:
        hash(value)
    except TypeError:
        return _Identity(value)
    return (type(value).__name__, value)


def jax_metric(cls: Any, *args: Any, **kwargs: Any) -> Any:
    """An instance of the JAX metric ``cls(*args, **kwargs)``, reset: the pooled one when this configuration was
    built before."""
    key = (cls, _key(args), _key(kwargs))
    metric = _POOL.get(key)
    if metric is None:
        metric = _POOL[key] = cls(*args, **kwargs)
    else:
        metric.reset()
    return metric


@pytest.fixture(autouse=True)
def jax_op_by_op(request: pytest.FixtureRequest) -> Iterator[None]:
    """Each test of the module that imports this fixture runs with JAX's jit disabled, but for the cases the
    module names in ``JAX_JITTED_CASES``."""
    try:
        import jax
    except ImportError:  # no JAX (the machine with the card): the card tests run as they are
        yield
        return
    if request.node.name in getattr(request.module, "JAX_JITTED_CASES", ()):
        yield
        return
    with jax.disable_jit():
        yield
