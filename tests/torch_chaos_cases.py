"""Shared helpers of the port's chaos tests: one scenario run through either package, with the values every
``compute`` of the factory's metrics returned, and the result keys the two packages must agree on.

A scenario's result dict holds evidence that depends on thread timing in both packages (the serving tier's
stall and shed counts under a held drain, the controller's transitions); ``comparable`` keeps the keys that
are a function of the seed alone. The JAX package's serve and online scenarios also run a sharded variant,
which waits for the shard in the port (ROADMAP.md, queue A, item 9c): its key is left out.
"""
from __future__ import annotations

import random
import tempfile
import warnings
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

#: result keys that depend on thread timing, by scenario
TIMING_KEYS = {
    "serve_queue_overflow": {"block_stalls"},
    "serve_oscillating_load": {"transitions", "adaptive_shed", "static_shed", "escalations"},
}
#: the JAX package's variants that wait for the shard
WAITING_VARIANTS = {"sharded"}


def recording(make: Callable[[], Any], log: List[np.ndarray]) -> Callable[[], Any]:
    """A factory whose metrics append every computed value (as numpy) to ``log``."""

    def factory() -> Any:
        m = make()
        real = m.compute

        def compute(*args: Any, **kwargs: Any) -> Any:
            value = real(*args, **kwargs)
            log.append(np.asarray(value.detach().cpu() if hasattr(value, "detach") else value))
            return value

        m.compute = compute
        return m

    return factory


def run_scenario(chaos_mod: Any, sync_mod: Any, name: str, make: Callable[[], Any], fn: Callable = None
                 ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """``name`` once, with JAX's matrix seeding for seed 1234, 6 batches and ``via="update"``: (result, values)."""
    fn = fn or getattr(chaos_mod, f"scenario_{name}")
    log: List[np.ndarray] = []
    sync_mod.reset_health_state()
    with tempfile.TemporaryDirectory() as workdir, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = fn(recording(make, log), random.Random(f"1234:{name}:update:0"), 6, "update", workdir)
    sync_mod.reset_health_state()
    return result, log


def comparable(name: str, result: Dict[str, Any]) -> Dict[str, Any]:
    """``result`` less its timing-dependent keys and the variants that wait for the shard."""
    drop = TIMING_KEYS.get(name, set())
    out = {}
    for key, value in result.items():
        if key in WAITING_VARIANTS or key in drop:
            continue
        out[key] = {k: v for k, v in value.items() if k not in drop} if isinstance(value, dict) else value
    return out
