"""The regression module metrics of the PyTorch port against the JAX package's, on the same seeded
numpy inputs, within rtol 1e-5 / atol 1e-6.

All 18 classes over their options, through ``forward`` (each batch's value) and ``compute``, and
the tensor-state ones through ``update_batches``; the ``full_state_update`` forwards (Pearson and
concordance on tensor states, Kendall on list states); the compute groups of the collections
that ``chip_smoke.py`` path K drives; float64, float16 and integer inputs; and the module edges:
``R2Score`` with one sample (the JAX module's 0.0) and with ``adjusted`` at and beyond ``n - 1``
(the JAX functional's value, where the JAX module's traced compute gives another), a zero in KL's
``q``, Tweedie's domain check (the port raises where the JAX module's jitted update accepts), and
the multi-output states of ``ExplainedVariance`` and ``R2Score``, which take the width of their
first ``(N, d)`` batch. On the emulated graph tier (``dispatch.EMULATE_ON_CPU``) the collections
give the eager tier's bits. The ``cuda`` test runs the same on the card:

    python -m pytest --noconftest tests/test_torch_regression_classes.py -m cuda
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.regression as pr
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jax():
    """The JAX package's side, imported here so that the card test runs without JAX."""
    pytest.importorskip("jax")
    import torchmetrics_tpu.functional as jf
    import torchmetrics_tpu.regression as jr
    from torchmetrics_tpu import MetricCollection as JaxCollection

    return SimpleNamespace(regression=jr, functional=jf, MetricCollection=JaxCollection)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _leaves(value):
    return list(value) if isinstance(value, tuple) else [value]


def _close(ours, theirs) -> None:
    ours, theirs = _leaves(ours), _leaves(theirs)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert o.dtype == torch.float32
        assert tuple(o.shape) == np.asarray(t).shape
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=RTOL, atol=ATOL, equal_nan=True)


def _batches(seed: int, shape, kind: str = "real", n_batches: int = 3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        preds = rng.randn(*shape).astype(np.float32)
        target = (0.7 * preds + 0.5 * rng.randn(*shape) + 1.5).astype(np.float32)
        if kind == "positive":
            preds, target = np.abs(preds) + np.float32(0.05), np.abs(target) + np.float32(0.05)
        elif kind == "ties":
            preds, target = np.round(preds * 2).astype(np.float32), np.round(target * 2).astype(np.float32)
        elif kind == "probs":
            preds, target = np.exp(preds) / np.exp(preds).sum(-1, keepdims=True), np.exp(target) / np.exp(target).sum(
                -1, keepdims=True)
            preds, target = preds.astype(np.float32), target.astype(np.float32)
        out.append((preds, target))
    return out


#: (class, constructor arguments, input kind, batch shape)
CLASSES = [
    ("MeanSquaredError", {}, "real", (64,)),
    ("MeanSquaredError", {"squared": False}, "real", (64,)),
    ("MeanSquaredError", {"num_outputs": 3}, "real", (64, 3)),
    ("MeanSquaredError", {"num_outputs": 3, "squared": False}, "real", (64, 3)),
    ("MeanAbsoluteError", {}, "real", (64, 2)),
    ("MeanSquaredLogError", {}, "positive", (64,)),
    ("MeanAbsolutePercentageError", {}, "real", (64,)),
    ("SymmetricMeanAbsolutePercentageError", {}, "real", (64,)),
    ("WeightedMeanAbsolutePercentageError", {}, "real", (64,)),
    *[("CosineSimilarity", {"reduction": r}, "real", (32, 6)) for r in ("sum", "mean", "none")],
    *[("KLDivergence", {"reduction": r}, "probs", (32, 5)) for r in ("mean", "sum", "none")],
    ("KLDivergence", {"log_prob": True}, "real", (32, 5)),
    ("LogCoshError", {}, "real", (64,)),
    ("LogCoshError", {"num_outputs": 3}, "real", (64, 3)),
    *[("MinkowskiDistance", {"p": p}, "real", (64,)) for p in (1, 2, 3)],
    *[("TweedieDevianceScore", {"power": p}, "positive", (64,)) for p in (-1, 0, 1, 1.5, 2, 3)],
    ("R2Score", {}, "real", (64,)),
    ("R2Score", {"adjusted": 3}, "real", (64,)),
    *[("R2Score", {"num_outputs": 3, "multioutput": m}, "real", (64, 3))
      for m in ("raw_values", "uniform_average", "variance_weighted")],
    ("R2Score", {"multioutput": "raw_values"}, "real", (64, 3)),
    ("RelativeSquaredError", {}, "real", (64,)),
    ("RelativeSquaredError", {"num_outputs": 3, "squared": False}, "real", (64, 3)),
    *[("ExplainedVariance", {"multioutput": m}, "real", (64, 3)) for m in ("raw_values", "uniform_average",
                                                                           "variance_weighted")],
    ("ExplainedVariance", {}, "real", (64,)),
    ("PearsonCorrCoef", {}, "real", (64,)),
    ("PearsonCorrCoef", {"num_outputs": 3}, "real", (64, 3)),
    ("ConcordanceCorrCoef", {}, "real", (64,)),
    ("ConcordanceCorrCoef", {"num_outputs": 3}, "real", (64, 3)),
    ("SpearmanCorrCoef", {}, "ties", (64,)),
    ("SpearmanCorrCoef", {"num_outputs": 2}, "ties", (64, 2)),
    *[("KendallRankCorrCoef", {"variant": v, "t_test": True, "alternative": a}, "ties", (40,))
      for v, a in (("a", "two-sided"), ("b", "less"), ("c", "greater"))],
    ("KendallRankCorrCoef", {"variant": "b", "num_outputs": 2}, "ties", (40, 2)),
]


@pytest.mark.parametrize("name,kwargs,kind,shape", CLASSES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CLASSES)])
def test_class_forward_and_compute_match_jax(jax, name, kwargs, kind, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Spearman's buffer warning
        ours, theirs = getattr(pr, name)(device="cpu", **kwargs), getattr(jax.regression, name)(**kwargs)
    for preds, target in _batches(len(name) + len(kwargs), shape, kind):
        _close(ours(*_t(preds, target)), theirs(preds, target))
    _close(ours.compute(), theirs.compute())
    for key, value in ours.metric_state.items():
        for entry in value if isinstance(value, list) else [value]:
            assert entry.dtype == torch.float32, key


TENSOR_STATE = [c for c in CLASSES if c[0] not in ("CosineSimilarity", "SpearmanCorrCoef", "KendallRankCorrCoef")
                and c[1].get("reduction") != "none"]


@pytest.mark.parametrize("name,kwargs,kind,shape", TENSOR_STATE, ids=[f"{c[0]}-{i}" for i, c in enumerate(TENSOR_STATE)])
def test_update_batches_matches_jax(jax, name, kwargs, kind, shape):
    """The port's ``update_batches`` against JAX's updates one batch at a time: JAX's own
    ``update_batches`` cannot widen a scalar state inside its scan (``R2Score()`` and
    ``ExplainedVariance`` on ``(N, d)`` batches raise there; ROADMAP queue C)."""
    batches = _batches(len(name) + 3, shape, kind, n_batches=4)
    ours, theirs = getattr(pr, name)(device="cpu", **kwargs), getattr(jax.regression, name)(**kwargs)
    ours.update_batches(*_t(*(np.stack(x) for x in zip(*batches))))
    for preds, target in batches:
        theirs.update(preds, target)
    _close(ours.compute(), theirs.compute())


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int64])
@pytest.mark.parametrize("name", ["MeanSquaredError", "R2Score", "PearsonCorrCoef", "SpearmanCorrCoef",
                                  "ExplainedVariance", "MeanAbsolutePercentageError"])
def test_class_input_dtypes_match_jax(jax, name, dtype):
    ours, theirs = getattr(pr, name)(device="cpu"), getattr(jax.regression, name)()
    rng = np.random.RandomState(3)
    for _ in range(2):
        preds = (rng.randn(50) * (20 if dtype == np.int64 else 2)).astype(dtype)
        target = (preds.astype(np.float64) + rng.randn(50) * 3).astype(dtype)
        ours.update(*_t(preds, target))
        theirs.update(preds, target)
    assert all(v.dtype == torch.float32 for k, v in ours.metric_state.items() if not isinstance(v, list))
    _close(ours.compute(), theirs.compute())


@pytest.fixture
def graph_tier(monkeypatch):
    """The graph tier emulated on the CPU: captures, replays and static buffers as on the card."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
    dispatch.STATS.reset()
    return dispatch.STATS


def test_r2_module_with_one_sample_matches_jax_module(jax, graph_tier, monkeypatch):
    """One sample: the JAX module's traced compute skips the ``n >= 2`` check and gives 0.0 (tss is 0);
    the port's module gives the same on both tiers, and reads nothing on the host."""
    theirs = jax.regression.R2Score()
    theirs.update(np.array([1.5], np.float32), np.array([2.0], np.float32))
    for tier in ("graph", "eager"):
        if tier == "eager":
            monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
        ours = pr.R2Score(device="cpu")
        value = ours(*_t(np.array([1.5], np.float32), np.array([2.0], np.float32)))
        _close(value, theirs.compute())
        _close(ours.compute(), theirs.compute())
    assert float(theirs.compute()) == 0.0


@pytest.mark.parametrize("adjusted", [3, 5])
def test_r2_module_adjusted_fallback_matches_jax_functional(jax, graph_tier, monkeypatch, adjusted):
    """``adjusted`` at (3) and beyond (5) ``n - 1`` on 4 samples: the standard score (0.2 here), as the
    JAX functional and the reference give it. The JAX module's traced compute applies the correction
    instead (-inf at ``n - 1``, 2.2 beyond it here; ROADMAP queue C), so the port's module is held
    to the functional."""
    from torchmetrics_tpu.utils.prints import reset_warning_cache

    reset_warning_cache()  # the JAX package warns once per process, and another test may have warned
    preds, target = np.array([2.0, 1.0, 2.0, 3.0], np.float32), np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    with pytest.warns(UserWarning):
        want = jax.functional.r2_score(preds, target, adjusted=adjusted)
    values = []
    for tier in ("graph", "eager"):
        if tier == "eager":
            monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
        ours = pr.R2Score(adjusted=adjusted, device="cpu")
        values.append(ours(*_t(preds, target)))
        _close(ours.compute(), want)
    assert graph_tier.captures == 1 and set(graph_tier.fallbacks) == {("R2Score", "forward", "fast_dispatch_env_off")}
    assert torch.equal(values[0], values[1])
    jax_module = jax.regression.R2Score(adjusted=adjusted)
    jax_module.update(preds, target)
    assert float(jax_module.compute()) != float(want)  # -inf at n - 1, 2.2 beyond it


def test_tweedie_module_checks_the_domain(jax):
    """The port runs the domain check in ``_validate``, outside any graph, and raises; the JAX module's
    jitted update skips it and returns NaN (ROADMAP queue C)."""
    preds, target = np.array([-1.0, 2.0], np.float32), np.array([1.0, 2.0], np.float32)
    theirs = jax.regression.TweedieDevianceScore(power=2)
    theirs.update(preds, target)
    assert np.isnan(float(theirs.compute()))
    ours = pr.TweedieDevianceScore(power=2, device="cpu")
    with pytest.raises(ValueError, match="strictly positive"):
        ours.update(*_t(preds, target))
    with pytest.raises(ValueError, match="not defined for power=0.5"):
        pr.TweedieDevianceScore(power=0.5, device="cpu")


def test_kl_module_zero_in_q_gives_inf(jax):
    p = np.array([[0.5, 0.5, 0.0], [0.2, 0.3, 0.5]], np.float32)
    q = np.array([[1.0, 0.0, 0.0], [0.1, 0.4, 0.5]], np.float32)
    for reduction in ("mean", "none"):
        ours, theirs = pr.KLDivergence(reduction=reduction, device="cpu"), jax.regression.KLDivergence(reduction=reduction)
        ours.update(*_t(p, q))
        theirs.update(p, q)
        _close(ours.compute(), theirs.compute())
        assert torch.isinf(ours.compute()).any()


def test_multi_output_states_widen_before_the_graph(jax, graph_tier):
    """``R2Score()`` and ``ExplainedVariance`` keep scalar sums until an ``(N, d)`` batch, which JAX
    broadcasts to ``(d,)``; the port widens them in ``_validate``, so the graph step captures with the
    wider buffers (no failed capture) and the values are JAX's. ``reset`` brings the scalars back."""
    batches = _batches(11, (40, 4))
    for name, kwargs in (("R2Score", {"multioutput": "raw_values"}), ("ExplainedVariance", {"multioutput": "raw_values"}),
                         ("RelativeSquaredError", {})):
        ours, theirs = getattr(pr, name)(device="cpu", **kwargs), getattr(jax.regression, name)(**kwargs)
        for preds, target in batches:
            _close(ours(*_t(preds, target)), theirs(preds, target))
        _close(ours.compute(), theirs.compute())
        ours.reset()
        assert all(v.ndim == 0 for v in ours.metric_state.values())
    assert graph_tier.captures == 3 and graph_tier.replays == 9 and not graph_tier.fallbacks


def k1_metrics(device):
    """The collection of ``chip_smoke.py`` path K1, in its order."""
    from chip_smoke import path_k_metrics

    return path_k_metrics("K1", device)


def _k1_jax(jax):
    r = jax.regression
    return jax.MetricCollection({
        "mse": r.MeanSquaredError(), "rmse": r.MeanSquaredError(squared=False), "mae": r.MeanAbsoluteError(),
        "r2": r.R2Score(), "rse": r.RelativeSquaredError(), "explained_variance": r.ExplainedVariance(),
        "pearson": r.PearsonCorrCoef(), "concordance": r.ConcordanceCorrCoef(), "mape": r.MeanAbsolutePercentageError(),
        "smape": r.SymmetricMeanAbsolutePercentageError(), "wmape": r.WeightedMeanAbsolutePercentageError(),
        "log_cosh": r.LogCoshError(), "minkowski": r.MinkowskiDistance(p=3),
    })


def test_compute_groups_match_jax(jax):
    """The K1 collection forms JAX's groups: MSE with RMSE, R² with RSE, Pearson with concordance."""
    ours, theirs = k1_metrics("cpu"), _k1_jax(jax)
    for preds, target in _batches(5, (100,))[:2]:
        values = ours(*_t(preds, target))
        want = theirs(preds, target)
        assert list(values) == list(want)
        for key in want:
            _close(values[key], want[key])
    assert list(ours.compute_groups.values()) == list(theirs.compute_groups.values())
    assert [g for g in ours.compute_groups.values() if len(g) > 1] == [["concordance", "pearson"], ["mse", "rmse"],
                                                                        ["r2", "rse"]]
    got, want = ours.compute(), theirs.compute()
    for key in want:
        _close(got[key], want[key])


def _run_k1(device, batches, tier: str, monkeypatch):
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
    mc = k1_metrics(device)
    steps = [mc(*[b.to(device) for b in batch]) for batch in batches]
    final = mc.compute()
    mc.reset()
    mc.update_batches(*[torch.stack([b[i] for b in batches]).to(device) for i in range(2)])
    swept = mc.compute()
    return [{k: v.cpu() for k, v in d.items()} for d in (*steps, final, swept)]


def _bits(results):
    return [{k: v.numpy().tobytes() for k, v in d.items()} for d in results]


def test_graph_tier_equals_eager_on_the_cpu(jax, graph_tier, monkeypatch):
    """The K1 collection: every forward, the compute and the ``update_batches`` + compute give the
    same bits on the emulated graph tier as eagerly, and JAX's values. The only fallbacks on the graph
    tier are those of the Pearson group (``full_state_update``: each member's own eager forward)."""
    batches = [tuple(_t(*b)) for b in _batches(29, (500,), n_batches=4)]
    graph = _run_k1(torch.device("cpu"), batches, "graph", monkeypatch)
    reasons = {key[1:] for key in graph_tier.fallbacks}
    assert graph_tier.captures >= 8 and reasons <= {("group_forward", "group_not_fusable"),
                                                      ("update", "fast_update_class_off")}
    eager = _run_k1(torch.device("cpu"), batches, "eager", monkeypatch)
    assert _bits(graph) == _bits(eager)
    theirs = _k1_jax(jax)
    for batch, step in zip(batches, graph):
        want = theirs(*(b.numpy() for b in batch))
        for key in want:
            _close(step[key], want[key])


def test_metrics_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
        pr.MeanSquaredError()
    with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
        pr.KendallRankCorrCoef()


@pytest.mark.cuda
def test_graph_tier_equals_eager_on_the_card(monkeypatch):
    """On the card: the K1 collection's graph tier equals its eager tier bit for bit, and both agree
    with the CPU within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph tier captures CUDA graphs")
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", False)
    dispatch.STATS.reset()
    batches = [tuple(_t(*b)) for b in _batches(29, (20_000,), n_batches=4)]
    card = torch.device("cuda", 0)
    graph = _run_k1(card, batches, "graph", monkeypatch)
    assert dispatch.STATS.captures >= 8
    eager = _run_k1(card, batches, "eager", monkeypatch)
    assert _bits(graph) == _bits(eager)
    cpu = _run_k1(torch.device("cpu"), batches, "eager", monkeypatch)
    for g, c in zip(graph, cpu):
        for key in c:
            np.testing.assert_allclose(g[key].numpy(), c[key].numpy(), rtol=1e-5, atol=1e-6)
