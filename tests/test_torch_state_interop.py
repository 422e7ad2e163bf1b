"""State carried from the JAX package into the port with ``interop.load_numpy_state``, for each family
of the rest of classification: a JAX metric accumulates three batches, its ``metric_state`` goes
across as numpy arrays, and the port's ``compute()`` gives JAX's value (rtol=1e-6: the same states
go through the same float32 reduction). Float32 states stay float32, JAX's int32 confusion
matrices and float32 counts become the port's int64 counts.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.interop import load_numpy_state


def _multiclass(rng, n=50):
    return rng.randn(n, 4).astype(np.float32), rng.randint(0, 4, n)


def _multilabel(rng, n=50):
    return rng.rand(n, 4).astype(np.float32), rng.randint(0, 2, (n, 4))


def _binary(rng, n=50):
    return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)


def _groups(rng, n=50):
    return rng.rand(n).astype(np.float32), rng.randint(0, 2, n), rng.randint(0, 3, n)


CASES = [
    ("MulticlassCohenKappa", {"num_classes": 4, "weights": "quadratic"}, _multiclass, torch.int64),
    ("MulticlassMatthewsCorrCoef", {"num_classes": 4}, _multiclass, torch.int64),
    ("MultilabelJaccardIndex", {"num_labels": 4}, _multilabel, torch.int64),
    ("MulticlassSpecificity", {"num_classes": 4}, _multiclass, torch.int64),
    ("BinaryHammingDistance", {"multidim_average": "global"}, _binary, torch.int64),
    ("Dice", {"num_classes": 4, "average": "macro"}, _multiclass, torch.float32),
    ("Dice", {"num_classes": 4, "average": "samples"}, _multiclass, torch.float32),
    ("MulticlassExactMatch", {"num_classes": 4}, _multiclass, torch.float32),
    ("MultilabelExactMatch", {"num_labels": 4, "multidim_average": "global"}, _multilabel, torch.float32),
    ("BinaryHingeLoss", {"squared": True}, _binary, torch.float32),
    ("MulticlassHingeLoss", {"num_classes": 4, "multiclass_mode": "one-vs-all"}, _multiclass, torch.float32),
    ("MultilabelRankingAveragePrecision", {"num_labels": 4}, _multilabel, torch.float32),
    ("MultilabelCoverageError", {"num_labels": 4}, _multilabel, torch.float32),
    ("BinaryGroupStatRates", {"num_groups": 3}, _groups, torch.float32),
    ("BinaryFairness", {"num_groups": 3}, _groups, torch.float32),
]


@pytest.mark.parametrize("name,kwargs,make,dtype", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_jax_state_loads_and_computes_the_same(name, kwargs, make, dtype):
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc

    rng = np.random.RandomState(len(name))
    theirs = getattr(jc, name)(**kwargs)
    for _ in range(3):
        theirs.update(*make(rng))
    arrays = {k: [np.asarray(e) for e in v] if isinstance(v, list) else np.asarray(v)
              for k, v in theirs.metric_state.items()}
    ours = load_numpy_state(getattr(tc, name)(device="cpu", **kwargs), arrays)
    for key, value in ours.metric_state.items():
        for entry in value if isinstance(value, list) else [value]:
            assert entry.dtype == dtype, key
    got, want = ours.compute(), theirs.compute()
    if isinstance(want, dict):
        assert list(got) == list(want)
        got, want = [got[k] for k in want], [want[k] for k in want]
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
