"""The port's ``plot`` (``utils/plot.py``, ``Metric.plot``, ``MetricCollection.plot`` and the 24 class overrides
of ``classification/``) against the JAX package's.

Each class is fed the same seeded batch in both packages and drawn by each under matplotlib's Agg backend;
the figures' artists must agree: every line's x and y data and label, every image's array, every text and
its position, the titles, axis labels, tick labels, the y-limits that the plot bounds set, and the bound
lines. ``MetricCollection.plot`` is drawn member by member and ``together``; a sequence of values draws
one line per class. Without matplotlib both raise JAX's ``ModuleNotFoundError`` text.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.utils import plot as port_plot

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    import torchmetrics_tpu.classification as jc

    return SimpleNamespace(top=jt, classification=jc)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _binary(rng, n=40):
    return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)


def _multiclass(rng, n=40, c=3):
    x = rng.rand(n, c).astype(np.float32)
    return x / x.sum(1, keepdims=True), rng.randint(0, c, n)


def _multilabel(rng, n=40, c=3):
    return rng.rand(n, c).astype(np.float32), rng.randint(0, 2, (n, c))


KW = {"Binary": ({}, _binary), "Multiclass": ({"num_classes": 3}, _multiclass),
      "Multilabel": ({"num_labels": 3}, _multilabel)}
FAMILIES = {"ROC": {"thresholds": 7}, "PrecisionRecallCurve": {"thresholds": 7}, "JaccardIndex": {},
            "CohenKappa": {}, "MatthewsCorrCoef": {}, "ConfusionMatrix": {}, "AUROC": {"thresholds": 7},
            "AveragePrecision": {"thresholds": 7}}
OVERRIDES = [(task, family) for family in FAMILIES for task in KW
             if not (family == "CohenKappa" and task == "Multilabel")]


def _signature(fig):
    """What a figure draws, artist by artist, as comparable plain values."""
    out = []
    for ax in fig.axes:
        item = {
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "ylim": np.round(np.asarray(ax.get_ylim(), np.float64), 6).tolist(),
            "xticks": [t.get_text() for t in ax.get_xticklabels()], "yticks": [t.get_text() for t in ax.get_yticklabels()],
            "lines": [(np.asarray(ln.get_xdata(), np.float64).tolist(), np.asarray(ln.get_ydata(), np.float64).tolist(),
                       ln.get_label(), ln.get_marker(), ln.get_linestyle()) for ln in ax.get_lines()],
            "images": [np.asarray(im.get_array(), np.float64).tolist() for im in ax.get_images()],
            "texts": [(t.get_text(), tuple(np.round(np.asarray(t.get_position(), np.float64), 6))) for t in ax.texts],
            "segments": [np.round(np.asarray(s, np.float64), 6).tolist() for c in ax.collections
                         for s in getattr(c, "get_segments", lambda: [])()],
            "visible": ax.get_visible(),
        }
        legend = ax.get_legend()
        item["legend"] = [t.get_text() for t in legend.get_texts()] if legend is not None else None
        out.append(item)
    return out


def _same(ours, theirs):
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert o.keys() == t.keys()
        for key in o:
            if key == "lines":
                assert len(o[key]) == len(t[key])
                for lo, lt in zip(o[key], t[key]):
                    np.testing.assert_allclose(lo[0], lt[0], rtol=1e-6, atol=1e-7)
                    np.testing.assert_allclose(lo[1], lt[1], rtol=1e-6, atol=1e-7)
                    assert lo[2:] == lt[2:]
            elif key == "images":
                for io, it in zip(o[key], t[key]):
                    np.testing.assert_allclose(io, it, rtol=1e-6)
            else:
                assert o[key] == t[key], key


def _pair(jax, name, kwargs):
    return getattr(jax.classification, name)(**kwargs), getattr(port.classification, name)(**kwargs, device="cpu")


@pytest.mark.parametrize("task,family", OVERRIDES, ids=[t + f for t, f in OVERRIDES])
def test_class_overrides_draw_what_jax_draws(jax, task, family):
    kwargs, data = KW[task]
    theirs, ours = _pair(jax, task + family, {**kwargs, **FAMILIES[family]})
    batch = data(np.random.RandomState(len(task + family)))
    theirs.update(*batch)
    ours.update(*(torch.from_numpy(a) for a in batch))
    fig_t, _ = theirs.plot()
    fig_o, _ = ours.plot()
    _same(_signature(fig_o), _signature(fig_t))


def test_confusion_matrix_keywords_and_curve_score(jax):
    """``add_text``, ``labels`` and ``cmap`` of the confusion matrices; ``score`` of the curves."""
    kwargs, data = KW["Multiclass"]
    batch = data(np.random.RandomState(5))
    theirs, ours = _pair(jax, "MulticlassConfusionMatrix", kwargs)
    theirs.update(*batch)
    ours.update(*(torch.from_numpy(a) for a in batch))
    labels = ["cat", "dog", "bird"]
    fig_t, _ = theirs.plot(add_text=False, labels=labels, cmap="Blues")
    fig_o, _ = ours.plot(add_text=False, labels=labels, cmap="Blues")
    _same(_signature(fig_o), _signature(fig_t))
    with pytest.raises(ValueError, match="labels"):
        ours.plot(labels=["a"])
    theirs, ours = _pair(jax, "MulticlassROC", {**kwargs, "thresholds": 7})
    theirs.update(*batch)
    ours.update(*(torch.from_numpy(a) for a in batch))
    score = np.array([0.5, 0.25, 0.75], np.float32)
    fig_t, _ = theirs.plot(score=score)
    fig_o, _ = ours.plot(score=torch.from_numpy(score))
    _same(_signature(fig_o), _signature(fig_t))


@pytest.mark.parametrize("name", ["MeanSquaredError", "MulticlassAccuracy", "sequence", "dict"])
def test_metric_plot_draws_what_jax_draws(jax, name):
    """``Metric.plot`` of a scalar with one bound, of per-class values with a legend, of a sequence of values,
    and of a dict of values."""
    rng = np.random.RandomState(6)
    if name == "MeanSquaredError":
        theirs, ours = jax.top.MeanSquaredError(), port.MeanSquaredError(device="cpu")
        batch = (rng.randn(20).astype(np.float32), rng.randn(20).astype(np.float32))
    else:
        theirs, ours = _pair(jax, "MulticlassAccuracy", {"num_classes": 3, "average": None})
        batch = _multiclass(rng)
    theirs.update(*batch)
    ours.update(*(torch.from_numpy(a) for a in batch))
    if name == "sequence":
        vals_t = [theirs.compute(), theirs.compute() * 0.5]
        vals_o = [ours.compute(), ours.compute() * 0.5]
    elif name == "dict":
        vals_t = {"a": theirs.compute()[0], "b": theirs.compute()[1]}
        vals_o = {"a": ours.compute()[0], "b": ours.compute()[1]}
    else:
        vals_t = vals_o = None
    fig_t, _ = theirs.plot(vals_t)
    fig_o, _ = ours.plot(vals_o)
    _same(_signature(fig_o), _signature(fig_t))


@pytest.mark.parametrize("together", [False, True])
def test_collection_plot_draws_what_jax_draws(jax, together):
    batch = _binary(np.random.RandomState(7))
    jc, pc = jax.classification, port.classification
    theirs = jax.top.MetricCollection([jc.BinaryAccuracy(), jc.BinaryPrecision(), jc.BinaryConfusionMatrix()])
    ours = port.MetricCollection([pc.BinaryAccuracy(device="cpu"), pc.BinaryPrecision(device="cpu"),
                                  pc.BinaryConfusionMatrix(device="cpu")])
    if together:
        theirs = jax.top.MetricCollection([jc.BinaryAccuracy(), jc.BinaryPrecision()])
        ours = port.MetricCollection([pc.BinaryAccuracy(device="cpu"), pc.BinaryPrecision(device="cpu")])
    theirs.update(*batch)
    ours.update(*(torch.from_numpy(a) for a in batch))
    drawn_t, drawn_o = theirs.plot(together=together), ours.plot(together=together)
    if together:
        drawn_t, drawn_o = [drawn_t], [drawn_o]
    assert len(drawn_o) == len(drawn_t)
    for (fig_o, _), (fig_t, _) in zip(drawn_o, drawn_t):
        _same(_signature(fig_o), _signature(fig_t))
    # on axes the caller gives
    if not together:
        _, axs_t = plt.subplots(1, 3)
        _, axs_o = plt.subplots(1, 3)
        theirs.plot(ax=axs_t)
        ours.plot(ax=axs_o)
        _same(_signature(axs_o[0].get_figure()), _signature(axs_t[0].get_figure()))


def test_without_matplotlib_both_raise_jax_s_error(jax, monkeypatch):
    import torchmetrics_tpu.utils.plot as jax_plot

    m = port.MeanSquaredError(device="cpu")
    m.update(torch.ones(3), torch.zeros(3))
    mc = port.MetricCollection([port.MeanSquaredError(device="cpu")])
    mc.update(torch.ones(3), torch.zeros(3))
    monkeypatch.setattr(jax_plot, "_MATPLOTLIB_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError) as theirs:
        jax_plot.plot_single_or_multi_val(1.0)
    monkeypatch.setattr(port_plot, "_MATPLOTLIB_AVAILABLE", False)
    for call in (m.plot, mc.plot, lambda: mc.plot(together=True)):
        with pytest.raises(ModuleNotFoundError) as ours:
            call()
        assert str(ours.value) == str(theirs.value)


def test_plot_attributes_are_jax_s(jax):
    """Every ported class carries JAX's ``plot_lower_bound``, ``plot_upper_bound`` and ``plot_legend_name``."""
    import importlib
    import inspect

    checked = 0
    for mod in ("", ".classification", ".regression", ".clustering", ".nominal", ".image", ".audio", ".text",
                ".multimodal", ".detection", ".retrieval", ".aggregation", ".wrappers", ".sketch", ".online"):
        ours, theirs = (importlib.import_module(p + mod) for p in ("torchmetrics_tpu_torch", "torchmetrics_tpu"))
        for name, cls in vars(ours).items():
            if inspect.isclass(cls) and issubclass(cls, port.Metric) and hasattr(theirs, name):
                for attr in ("plot_lower_bound", "plot_upper_bound", "plot_legend_name"):
                    assert getattr(cls, attr) == getattr(getattr(theirs, name), attr), (mod, name, attr)
                checked += 1
    assert checked > 250
