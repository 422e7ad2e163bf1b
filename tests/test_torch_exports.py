"""The port's public names against the JAX package's, for the domains the port has ported.

Every class and function of ``torchmetrics_tpu.classification``, ``torchmetrics_tpu.regression``
and their ``functional`` modules exists in the port under the same name and in the same place; every name of ``torchmetrics_tpu.__all__`` and ``torchmetrics_tpu.functional.__all__``
whose domain is ported imports from the port's top level or ``functional``. The coverage meter
prints how many names of each ``__all__`` the port still lacks (run with ``-s`` to see it).
"""
from __future__ import annotations

import inspect

import pytest

import torchmetrics_tpu_torch as port
import torchmetrics_tpu_torch.classification as port_classification
import torchmetrics_tpu_torch.functional as port_functional
import torchmetrics_tpu_torch.functional.classification as port_functional_classification
import torchmetrics_tpu_torch.functional.regression as port_functional_regression
import torchmetrics_tpu_torch.regression as port_regression

#: the JAX package's modules whose names the port has ported, by domain
PORTED_MODULES = ("torchmetrics_tpu.classification", "torchmetrics_tpu.functional.classification",
                  "torchmetrics_tpu.regression", "torchmetrics_tpu.functional.regression", "torchmetrics_tpu.aggregation", "torchmetrics_tpu.retrieval", "torchmetrics_tpu.functional.retrieval",
                  "torchmetrics_tpu.metric", "torchmetrics_tpu.collections", "torchmetrics_tpu.wrappers")
#: names of ``torchmetrics_tpu.__all__`` that are modules or the version, not metrics
NOT_METRICS = {"functional", "obs", "robust", "__version__"}


@pytest.fixture(scope="module")
def jax_package():
    pytest.importorskip("jax")
    import torchmetrics_tpu
    import torchmetrics_tpu.functional

    return torchmetrics_tpu


def _public(module, kind):
    return {n for n in dir(module) if not n.startswith("_") and kind(getattr(module, n))}


def _ported(module, names):
    """The names of ``module`` whose object is defined in a ported domain."""
    return {n for n in names if (getattr(getattr(module, n), "__module__", "") or "").startswith(PORTED_MODULES)}


def test_every_classification_class_and_function_is_ported(jax_package):
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional.classification as jfc

    classes = _public(jc, inspect.isclass)
    functions = _public(jfc, inspect.isfunction)
    assert len(classes) == 90 and len(functions) == 89
    assert sorted(classes - set(port_classification.__all__)) == []
    assert sorted(functions - set(port_functional_classification.__all__)) == []
    for name in classes:
        assert inspect.isclass(getattr(port_classification, name)), name
    for name in functions:
        assert callable(getattr(port_functional_classification, name)), name


def test_every_regression_class_and_function_is_ported(jax_package):
    import torchmetrics_tpu.functional.regression as jfr
    import torchmetrics_tpu.regression as jr

    classes = _public(jr, inspect.isclass)
    functions = _public(jfr, inspect.isfunction)
    assert len(classes) == 18 and len(functions) == 18
    assert sorted(classes) == sorted(port_regression.__all__) and sorted(functions) == sorted(port_functional_regression.__all__)
    for name in classes:
        assert inspect.isclass(getattr(port_regression, name)), name
        assert getattr(port, name) is getattr(port_regression, name), name
    for name in functions:
        assert callable(getattr(port_functional_regression, name)), name
        assert getattr(port_functional, name) is getattr(port_functional_regression, name), name


def test_top_level_exports_every_ported_name(jax_package):
    """The repair of the top-level exports: ``from torchmetrics_tpu_torch import Accuracy`` works for
    every ported class that ``torchmetrics_tpu.__all__`` lists."""
    wanted = _ported(jax_package, set(jax_package.__all__) - NOT_METRICS)
    assert {"Accuracy", "ConfusionMatrix", "SumMetric", "RunningMean", "CohenKappa", "Dice", "RetrievalMAP",
            "R2Score", "KendallRankCorrCoef", "BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric",
            "MultioutputWrapper", "MultitaskWrapper"} <= wanted
    assert sorted(wanted - set(port.__all__)) == []
    for name in wanted:
        assert getattr(port, name).__name__ == name


def test_functional_exports_every_ported_name(jax_package):
    import torchmetrics_tpu.functional as jf

    wanted = _ported(jf, set(jf.__all__))
    assert sorted(wanted - set(port_functional.__all__)) == []
    for name in wanted:
        assert callable(getattr(port_functional, name)), name


def test_coverage_meter(jax_package, capsys):
    """How many names of each ``__all__`` the port still lacks (the rest of queue A of the roadmap)."""
    import torchmetrics_tpu.functional as jf

    lines, ported = [], {}
    for label, theirs, ours in (("torchmetrics_tpu.__all__", jax_package.__all__, port.__all__),
                                ("torchmetrics_tpu.functional.__all__", jf.__all__, port_functional.__all__)):
        names = set(theirs) - NOT_METRICS
        missing = names - set(ours)
        ported[label] = (len(names) - len(missing), len(names))
        lines.append(f"{label}: {len(names) - len(missing)} of {len(names)} names ported, {len(missing)} to go")
    with capsys.disabled():
        print("\n" + "\n".join(lines))
    assert all("names ported" in line for line in lines)
    assert ported["torchmetrics_tpu.__all__"] == (66, 150)  # after the wrappers (slice 10)
