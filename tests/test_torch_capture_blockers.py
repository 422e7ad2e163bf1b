"""What a captured step may not do, checked on the CPU, and the repairs that cleared it.

A CUDA graph cannot capture a read of the device by the host (``.item()``, ``bool(tensor)``,
``.tolist()``: ``aten._local_scalar_dense``), an output whose shape depends on the data
(``nonzero``, boolean-mask indexing) or a tensor built from host data (``torch.tensor(...)``:
``aten.lift_fresh``, a host-to-device copy on the card). The fused forward step of each metric of
the main paths (its update on the defaults, its compute, the merge) runs here under a dispatch mode
that raises on any of them. ``_safe_divide`` and the partial AUROC's ``max_fpr`` built a tensor
from a Python scalar on every call; they now pass the scalar itself, and their values are held
to the JAX package's on the same inputs.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torchmetrics_tpu_torch.audio as pa
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional.audio as pfa
import torchmetrics_tpu_torch.image as ti
import torchmetrics_tpu_torch.regression as rg
import torchmetrics_tpu_torch.retrieval as pr
from torchmetrics_tpu.functional.classification import binary_auroc as jax_binary_auroc
from torchmetrics_tpu.utils.compute import _safe_divide as jax_safe_divide
from torchmetrics_tpu_torch import aggregation as ta
from torchmetrics_tpu_torch.functional.classification import binary_auroc
from torchmetrics_tpu_torch.metric import _merge_tensor_ladder
from torchmetrics_tpu_torch.utils import checks
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

UNCAPTURABLE = ("_local_scalar_dense", "nonzero", "lift_fresh", "masked_select", "unique")


class _NoHostSync(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(bad in name for bad in UNCAPTURABLE):
            raise AssertionError(f"{name} cannot be captured in a CUDA graph")
        return func(*args, **(kwargs or {}))


METRICS = {
    "A MulticlassF1Score": (lambda: tc.MulticlassF1Score(num_classes=5, validate_args=False, device="cpu"), "labels"),
    "A MulticlassAccuracy": (lambda: tc.MulticlassAccuracy(num_classes=5, average="micro", device="cpu"), "labels"),
    "E BinaryF1Score": (lambda: tc.BinaryF1Score(device="cpu"), "binary"),
    "C BinaryAveragePrecision": (lambda: tc.BinaryAveragePrecision(thresholds=200, device="cpu"), "binary"),
    "F BinaryRecallAtFixedPrecision": (lambda: tc.BinaryRecallAtFixedPrecision(0.5, thresholds=200, device="cpu"), "binary"),
    "F BinarySpecificityAtSensitivity": (lambda: tc.BinarySpecificityAtSensitivity(0.5, thresholds=200, device="cpu"),
                                         "binary"),
    "F BinaryAUROC max_fpr": (lambda: tc.BinaryAUROC(thresholds=200, max_fpr=0.3, device="cpu"), "binary"),
    "D BinaryAUROC sketch": (lambda: tc.BinaryAUROC(approx="sketch", device="cpu"), "binary"),
    "D MulticlassAUROC sketch": (lambda: tc.MulticlassAUROC(num_classes=5, approx="sketch", device="cpu"), "scores"),
    "G MeanMetric": (lambda: ta.MeanMetric(device="cpu"), "values"),
    "G SumMetric": (lambda: ta.SumMetric(device="cpu"), "values"),
    "J MulticlassCohenKappa": (lambda: tc.MulticlassCohenKappa(5, weights="quadratic", device="cpu"), "scores"),
    "J MulticlassMatthewsCorrCoef": (lambda: tc.MulticlassMatthewsCorrCoef(5, device="cpu"), "scores"),
    "J MulticlassJaccardIndex": (lambda: tc.MulticlassJaccardIndex(5, ignore_index=1, device="cpu"), "scores"),
    "J MulticlassSpecificity": (lambda: tc.MulticlassSpecificity(5, device="cpu"), "scores"),
    "J MulticlassHammingDistance": (lambda: tc.MulticlassHammingDistance(5, device="cpu"), "scores"),
    "J MulticlassHingeLoss": (lambda: tc.MulticlassHingeLoss(5, device="cpu"), "scores"),
    "J MulticlassHingeLoss one-vs-all": (lambda: tc.MulticlassHingeLoss(5, multiclass_mode="one-vs-all", device="cpu"),
                                         "scores"),
    "J Dice": (lambda: tc.Dice(num_classes=5, average="macro", device="cpu"), "scores"),
    "J Dice ignore_index": (lambda: tc.Dice(num_classes=5, average="none", ignore_index=2, device="cpu"), "labels"),
    "J Dice multiclass=False": (lambda: tc.Dice(multiclass=False, device="cpu"), "binary"),
    "J MultilabelRankingAveragePrecision": (lambda: tc.MultilabelRankingAveragePrecision(5, ignore_index=-1, device="cpu"), "multilabel"),
    "J MultilabelRankingLoss": (lambda: tc.MultilabelRankingLoss(5, ignore_index=-1, device="cpu"), "multilabel"),
    "J MultilabelCoverageError": (lambda: tc.MultilabelCoverageError(5, ignore_index=-1, device="cpu"), "multilabel"),
    "J MultilabelExactMatch": (lambda: tc.MultilabelExactMatch(5, ignore_index=-1, device="cpu"), "multilabel"),
    "J MultilabelJaccardIndex": (lambda: tc.MultilabelJaccardIndex(5, ignore_index=-1, device="cpu"), "multilabel"),
    "J MultilabelMatthewsCorrCoef": (lambda: tc.MultilabelMatthewsCorrCoef(5, ignore_index=-1, device="cpu"), "multilabel"),
    "J MultilabelHammingDistance": (lambda: tc.MultilabelHammingDistance(5, ignore_index=-1, device="cpu"), "multilabel"),
    "J BinaryGroupStatRates": (lambda: tc.BinaryGroupStatRates(8, device="cpu"), "groups"),
    "J BinaryCohenKappa": (lambda: tc.BinaryCohenKappa(device="cpu"), "binary"),
    "J BinaryMatthewsCorrCoef": (lambda: tc.BinaryMatthewsCorrCoef(device="cpu"), "binary"),
    "J BinaryHingeLoss": (lambda: tc.BinaryHingeLoss(squared=True, device="cpu"), "binary"),
    "J BinarySpecificity": (lambda: tc.BinarySpecificity(device="cpu"), "binary"),
}


def _inputs(kind: str):
    rng = np.random.RandomState(0)
    if kind == "labels":
        return torch.from_numpy(rng.randint(0, 5, 200)), torch.from_numpy(rng.randint(0, 5, 200))
    if kind == "binary":
        return torch.from_numpy(rng.rand(200).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 200))
    if kind == "scores":
        return torch.from_numpy(rng.rand(200, 5).astype(np.float32)), torch.from_numpy(rng.randint(0, 5, 200))
    if kind == "multilabel":
        target = rng.randint(0, 2, (200, 5))
        target[rng.rand(200, 5) < 0.1] = -1
        return torch.from_numpy(rng.rand(200, 5).astype(np.float32)), torch.from_numpy(target)
    if kind == "groups":
        return (torch.from_numpy(rng.rand(200).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 200)),
                torch.from_numpy(rng.randint(0, 8, 200)))
    return (torch.from_numpy(rng.randn(200).astype(np.float32)),)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_fused_step_makes_no_host_read(name, monkeypatch):
    monkeypatch.setattr(checks, "capturing", lambda x: True)  # as under capture: the host-read warnings are skipped
    make, kind = METRICS[name]
    m = make()
    args = _inputs(kind)
    defaults = m._default_state()
    with _NoHostSync():
        batch_out = m._update(dict(defaults), *args)
        batch_state = {k: batch_out.get(k, v) for k, v in defaults.items()}
        m._compute(batch_state)
        n = torch.ones((), dtype=torch.float32)
        _merge_tensor_ladder(dict(m._tensors), batch_out, m._defaults, m._reductions, n)


def test_the_checks_catch_a_host_read():
    with pytest.raises(AssertionError, match="cannot be captured"):
        with _NoHostSync():
            torch.ones(3).sum().item()
    with pytest.raises(AssertionError, match="cannot be captured"):
        with _NoHostSync():
            torch.where(torch.ones(3) > 0, torch.tensor(2.0), torch.ones(3))


@pytest.mark.parametrize("zero_division", [0.0, 1.0, float("nan")], ids=["0", "1", "nan"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_safe_divide_value_unchanged(zero_division, dtype):
    rng = np.random.RandomState(1)
    num = rng.randint(0, 9, 50).astype(dtype)
    denom = rng.randint(0, 3, 50).astype(dtype)
    ours = _safe_divide(torch.from_numpy(num), torch.from_numpy(denom), zero_division=zero_division)
    theirs = jax_safe_divide(jnp.asarray(num), jnp.asarray(denom), zero_division=zero_division)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("max_fpr", [0.05, 0.3, 1.0])
@pytest.mark.parametrize("thresholds", [None, 50])
def test_partial_auroc_value_unchanged(max_fpr, thresholds):
    rng = np.random.RandomState(2)
    preds = rng.rand(400).astype(np.float32)
    target = (rng.rand(400) < preds).astype(np.int32)
    ours = binary_auroc(torch.from_numpy(preds), torch.from_numpy(target), max_fpr=max_fpr, thresholds=thresholds)
    theirs = jax_binary_auroc(jnp.asarray(preds), jnp.asarray(target), max_fpr=max_fpr, thresholds=thresholds)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


RETRIEVAL = {
    "H RetrievalMAP": lambda: pr.RetrievalMAP(ignore_index=-1, device="cpu"),
    "H RetrievalNormalizedDCG": lambda: pr.RetrievalNormalizedDCG(top_k=5, device="cpu"),
    "H RetrievalMAP median": lambda: pr.RetrievalMAP(aggregation="median", device="cpu"),
    "H RetrievalPrecisionRecallCurve": lambda: pr.RetrievalPrecisionRecallCurve(adaptive_k=True, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(RETRIEVAL))
def test_flat_retrieval_compute_makes_no_host_read(name, monkeypatch):
    """The flat compute that the card captures as one graph per padded length: sort, segments,
    kernel, empty action and aggregation, on 300 documents (padded to 512). The curve's one host
    read (``max_k``) comes before the captured program and stays outside it."""
    monkeypatch.setattr(checks, "capturing", lambda x: True)
    rng = np.random.RandomState(3)
    m = RETRIEVAL[name]()
    target = rng.randint(0, 2, 300)
    target[rng.rand(300) < 0.1] = -1
    m.update(torch.from_numpy((rng.randint(0, 9, 300) / 9.0).astype(np.float32)), torch.from_numpy(target),
             indexes=torch.from_numpy(np.sort(rng.randint(0, 20, 300))))
    indexes, preds, target, valid = m._state_arrays(m._computable_state())
    with _NoHostSync():
        if isinstance(m, pr.RetrievalPrecisionRecallCurve):
            m._curve_flat(indexes, preds, target, valid, 17)
        else:
            m._flat_aggregate(indexes, preds, target, valid, "pos", "no positive target")


@pytest.fixture
def graphs_without_host_reads(monkeypatch):
    """The graph tier emulated on the CPU (``dispatch.EMULATE_ON_CPU``), with every capture and every
    replay run under the mode that raises on a host read or host data: what a step does there is
    what the card would capture. The validation before a step runs outside the mode."""
    from torchmetrics_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    capture, replay = dispatch.capture, dispatch.StepGraph.replay

    def guarded_capture(*args, **kwargs):
        with _NoHostSync():
            return capture(*args, **kwargs)

    def guarded_replay(self):
        with _NoHostSync():
            return replay(self)

    monkeypatch.setattr(dispatch, "capture", guarded_capture)
    monkeypatch.setattr(dispatch.StepGraph, "replay", guarded_replay)
    dispatch.STATS.reset()
    return dispatch.STATS


def test_dice_host_reads_stay_out_of_the_graph(graphs_without_host_reads):
    """``Dice(multiclass=False)`` reads the device for its value checks in ``_validate``; its fused
    forward runs as one emulated graph, captured once and replayed, with no host read inside."""
    stats = graphs_without_host_reads
    rng = np.random.RandomState(5)
    metric, eager = tc.Dice(multiclass=False, average="macro", device="cpu"), []
    for _ in range(4):
        preds, target = torch.from_numpy(rng.randint(0, 2, 100)), torch.from_numpy(rng.randint(0, 2, 100))
        metric(preds, target)
        eager.append((preds, target))
    assert stats.captures == 1 and stats.replays == 4 and stats.n_fallbacks == 0
    with pytest.raises(ValueError, match="should not exceed 1"):
        metric(torch.tensor([0, 2, 1]), torch.tensor([0, 1, 1]))
    from torchmetrics_tpu_torch.functional import dice

    want = dice(torch.cat([p for p, _ in eager]), torch.cat([t for _, t in eager]), multiclass=False, average="macro")
    torch.testing.assert_close(metric.compute(), want, rtol=1e-6, atol=0)


def test_binary_fairness_compute_stays_out_of_the_graph(graphs_without_host_reads):
    """``BinaryFairness.jit_compute`` is False: its forward is not fused (it runs eagerly, noted
    ``not_fusable``) and its compute, which reads the argmin and argmax groups on the host, runs
    outside any graph; its update still runs as one emulated graph on the ``fast_update`` tier."""
    stats = graphs_without_host_reads
    rng = np.random.RandomState(6)
    batches = [(torch.from_numpy(rng.rand(100).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 100)),
                torch.from_numpy(rng.randint(0, 3, 100))) for _ in range(3)]
    metric = tc.BinaryFairness(3, device="cpu")
    value = metric(*batches[0])
    assert stats.captures == 0 and stats.fallbacks[("BinaryFairness", "forward", "not_fusable")] == 1
    assert sorted(k[:2] for k in value) == ["DP", "EO"]
    metric.fast_update = True
    for batch in batches[1:]:
        metric.update(*batch)
    assert stats.captures == 1 and stats.replays == 2
    reference = tc.BinaryFairness(3, device="cpu")
    for batch in batches:
        reference.update(*batch)
    assert torch.equal(metric.metric_state["stats"], reference.metric_state["stats"])
    got, want = metric.compute(), reference.compute()
    assert list(got) == list(want)


def _regression_inputs(kind: str):
    rng = np.random.RandomState(9)
    shape = {"one": (200,), "three": (200, 3), "eight": (200, 8), "rows": (50, 6)}[kind.split("-")[0]]
    preds = rng.randn(*shape).astype(np.float32)
    target = (preds + rng.randn(*shape) + 2.0).astype(np.float32)
    if kind.endswith("positive"):
        preds, target = np.abs(preds) + np.float32(0.1), np.abs(target) + np.float32(0.1)
    elif kind.endswith("ties"):
        preds[::7] = np.nan
        preds, target = np.round(preds), np.round(target)
    return torch.from_numpy(preds), torch.from_numpy(target)


REGRESSION = {
    "K1 MeanSquaredError": (lambda: rg.MeanSquaredError(device="cpu"), "one"),
    "K1 MeanAbsoluteError": (lambda: rg.MeanAbsoluteError(device="cpu"), "one"),
    "K1 R2Score adjusted": (lambda: rg.R2Score(adjusted=3, device="cpu"), "one"),
    "K1 RelativeSquaredError": (lambda: rg.RelativeSquaredError(squared=False, device="cpu"), "one"),
    "K1 ExplainedVariance": (lambda: rg.ExplainedVariance(device="cpu"), "one"),
    "K1 PearsonCorrCoef": (lambda: rg.PearsonCorrCoef(device="cpu"), "one"),
    "K1 ConcordanceCorrCoef": (lambda: rg.ConcordanceCorrCoef(device="cpu"), "one"),
    "K1 MeanAbsolutePercentageError": (lambda: rg.MeanAbsolutePercentageError(device="cpu"), "one"),
    "K1 SymmetricMeanAbsolutePercentageError": (lambda: rg.SymmetricMeanAbsolutePercentageError(device="cpu"), "one"),
    "K1 WeightedMeanAbsolutePercentageError": (lambda: rg.WeightedMeanAbsolutePercentageError(device="cpu"), "one"),
    "K1 LogCoshError": (lambda: rg.LogCoshError(device="cpu"), "one"),
    "K1 MinkowskiDistance": (lambda: rg.MinkowskiDistance(p=3, device="cpu"), "one"),
    "K2 MeanSquaredError": (lambda: rg.MeanSquaredError(num_outputs=8, device="cpu"), "eight"),
    "K2 R2Score raw_values": (lambda: rg.R2Score(multioutput="raw_values", device="cpu"), "eight"),
    "K2 R2Score variance_weighted": (lambda: rg.R2Score(multioutput="variance_weighted", device="cpu"), "eight"),
    "K2 ExplainedVariance": (lambda: rg.ExplainedVariance(multioutput="raw_values", device="cpu"), "eight"),
    "K2 PearsonCorrCoef": (lambda: rg.PearsonCorrCoef(num_outputs=8, device="cpu"), "eight"),
    "K2 LogCoshError": (lambda: rg.LogCoshError(num_outputs=8, device="cpu"), "eight"),
    "K3 SpearmanCorrCoef": (lambda: rg.SpearmanCorrCoef(num_outputs=3, device="cpu"), "three-ties"),
    "K3 KendallRankCorrCoef b": (lambda: rg.KendallRankCorrCoef(t_test=True, device="cpu"), "one-ties"),
    "K3 KendallRankCorrCoef c": (lambda: rg.KendallRankCorrCoef(variant="c", t_test=True, num_outputs=3, device="cpu"),
                                 "three-ties"),
    "K4 CosineSimilarity": (lambda: rg.CosineSimilarity(reduction="mean", device="cpu"), "rows"),
    "K4 KLDivergence": (lambda: rg.KLDivergence(device="cpu"), "rows-positive"),
    "K4 KLDivergence log_prob none": (lambda: rg.KLDivergence(log_prob=True, reduction="none", device="cpu"), "rows"),
    "K4 TweedieDevianceScore": (lambda: rg.TweedieDevianceScore(power=1.5, device="cpu"), "one-positive"),
    "K4 MeanSquaredLogError": (lambda: rg.MeanSquaredLogError(device="cpu"), "one-positive"),
}


@pytest.mark.parametrize("name", sorted(REGRESSION))
def test_regression_update_and_compute_make_no_host_read(name):
    """Each regression update on the defaults and its compute on that batch state (list states
    concatenated), and the merge of a fused forward, under the mode that raises on a host read or
    host data. The input checks, and Tweedie's domain check, run in ``_validate`` before it."""
    make, kind = REGRESSION[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Spearman's buffer warning
        m = make()
    args = _regression_inputs(kind)
    m._validate(*args)
    defaults = m._default_state()
    with _NoHostSync():
        batch_out = m._update(dict(defaults), *args)
        batch_state = {k: batch_out.get(k, v) for k, v in defaults.items()}
        for state in m._lists:
            batch_state[state] = dim_zero_cat([batch_out[state]])
        m._compute(batch_state)
        if m._fusable_forward():
            _merge_tensor_ladder(dict(m._tensors), batch_out, m._defaults, m._reductions, torch.ones(()))


def test_regression_collections_run_as_graphs_without_host_reads(graphs_without_host_reads):
    """Path K1's and K2's collections through ``forward`` on the emulated graph tier: every group but
    Pearson's (``full_state_update``, eager) is one graph, captured once and replayed, with no host
    read inside; the multi-output states widen before their first capture."""
    import chip_smoke

    stats = graphs_without_host_reads
    rng = np.random.RandomState(10)
    for part, width, graphs in (("K1", None, 9), ("K2", 8, 4)):
        mc = chip_smoke.path_k_metrics(part, "cpu")
        shape = (100,) if width is None else (100, width)
        for step in range(3):
            captures, replays = stats.captures, stats.replays
            mc(torch.from_numpy(rng.randn(*shape).astype(np.float32)),
               torch.from_numpy(rng.randn(*shape).astype(np.float32) + 3))
        assert stats.captures == captures and stats.replays - replays == graphs  # the last step: replays only
    assert {key[1:] for key in stats.fallbacks} <= {("group_forward", "group_not_fusable"), ("update", "fast_update_class_off")}


def test_wrapped_metrics_still_run_as_graphs(graphs_without_host_reads):
    """The wrappers' inner steps on the emulated graph tier: each wrapped metric's fused forward (or
    its ``fast_update`` update: ``BootStrapper``'s copies under multinomial resampling, whose
    batches keep their shape, and ``MinMaxMetric``'s base) is captured once and then replayed, with no host read inside. What
    the wrappers read on the host (the resample indices, ``MultioutputWrapper``'s NaN rows) stays
    outside the graphs, and the values equal the eager tier's."""
    from torchmetrics_tpu_torch import MetricCollection, wrappers
    from torchmetrics_tpu_torch.ops import dispatch

    stats = graphs_without_host_reads
    rng = np.random.RandomState(12)
    labels = [(torch.from_numpy(rng.randint(0, 5, 200)), torch.from_numpy(rng.randint(0, 5, 200))) for _ in range(4)]
    columns = [(torch.from_numpy(rng.rand(200, 3).astype(np.float32)), torch.from_numpy(rng.rand(200, 3).astype(np.float32)))
               for _ in range(4)]

    def acc():
        return tc.MulticlassAccuracy(num_classes=5, device="cpu")

    def fast(metric):
        metric.fast_update = True  # plain updates on the graph tier too
        return metric

    def boot():
        return wrappers.BootStrapper(fast(acc()), num_bootstraps=3, sampling_strategy="multinomial", seed=1, raw=True)

    cases = {
        "BootStrapper": (boot, "update", labels, 3),
        "ClasswiseWrapper": (lambda: wrappers.ClasswiseWrapper(tc.MulticlassAccuracy(num_classes=5, average=None, device="cpu")),
                             "forward", labels, 1),
        "MultioutputWrapper": (lambda: wrappers.MultioutputWrapper(rg.MeanSquaredError(device="cpu"), num_outputs=3),
                               "forward", columns, 3),
        "MultitaskWrapper": (lambda: wrappers.MultitaskWrapper({"acc": acc(), "mse": rg.MeanSquaredError(device="cpu")}),
                             "forward", [({"acc": lb[0], "mse": c[0][:, 0]}, {"acc": lb[1], "mse": c[1][:, 0]})
                                         for lb, c in zip(labels, columns)], 2),
        "MetricTracker": (lambda: wrappers.MetricTracker(MetricCollection([acc(), tc.MulticlassF1Score(5, device="cpu")])),
                          "forward", labels, 3),  # two members' first forwards, then the group's graph
        "MinMaxMetric": (lambda: wrappers.MinMaxMetric(fast(tc.BinaryAccuracy(device="cpu"))), "forward",
                         [(p.float() / 5, (t > 2).long()) for p, t in labels], 1),
    }
    for name, (make, call, batches, graphs) in cases.items():
        values = {}
        for tier in ("graph", "eager"):
            dispatch.EMULATE_ON_CPU = tier == "graph"
            wrapper = make()
            if name == "MetricTracker":
                wrapper.increment()
            captures, replays = stats.captures, stats.replays
            for i, batch in enumerate(batches):
                if i == len(batches) - 1 and tier == "graph":
                    captures_before_last = stats.captures
                getattr(wrapper, call)(*batch)
            if tier == "graph":
                assert stats.captures - captures == graphs, name
                assert stats.captures == captures_before_last, name  # the last step replays only
                assert stats.replays - replays >= graphs, name
            values[tier] = wrapper.compute()
        dispatch.EMULATE_ON_CPU = True
        flat = [torch.as_tensor(v) for v in (values["graph"].values() if isinstance(values["graph"], dict) else [values["graph"]])]
        flat_e = [torch.as_tensor(v) for v in (values["eager"].values() if isinstance(values["eager"], dict) else [values["eager"]])]
        assert all(torch.equal(a, b) for a, b in zip(flat, flat_e)), name


def test_sketch_and_keyed_steps_run_as_graphs_without_host_reads(graphs_without_host_reads):
    """The streaming metrics' updates and forwards, and the keyed updates of every template of path N
    (sum, the sketched AUROC and the histogram through K2's vmap rule, the quantile's per-row fold), as
    graphs with no host read: one capture per step kind and signature, no fallback."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.keyed import KeyedMetric

    stats = graphs_without_host_reads
    rng = np.random.RandomState(12)
    values = torch.from_numpy(rng.lognormal(3, 1, 300).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 6, 300).astype(np.int32))
    scores, clicks = torch.from_numpy(rng.rand(300).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 300))
    steps = [
        (tm.StreamingQuantile(q=(0.5, 0.99), capacity=16, levels=8, device="cpu"), "update", (values,)),
        (tm.StreamingQuantile(q=0.5, capacity=16, levels=8, device="cpu"), "forward", (values,)),
        (tm.StreamingHistogram(bins=16, lo=0.0, hi=200.0, device="cpu"), "update", (values,)),
        (KeyedMetric(ta.SumMetric(nan_strategy="ignore", device="cpu"), 6), "update", (ids, values)),
        (KeyedMetric(tc.BinaryAUROC(approx="sketch", sketch_bins=32, device="cpu"), 6), "update", (ids, scores, clicks)),
        (KeyedMetric(tm.StreamingHistogram(bins=8, device="cpu"), 6), "update", (ids, scores)),
        (KeyedMetric(tm.StreamingQuantile(capacity=8, levels=6, device="cpu"), 6), "update", (ids[:20], values[:20])),
    ]
    for metric, op, args in steps:
        for _ in range(2):
            getattr(metric, op)(*args)
    assert stats.captures == len(steps) and stats.replays == 2 * len(steps) and not stats.fallbacks


def test_online_steps_run_as_graphs_without_host_reads(graphs_without_host_reads):
    """Path O's steps as graphs with no host read: the windowed updates (the slot a device scalar: no
    read picks the ring's row), the decayed updates, the merged ring's state and value, the manual
    advance and a live series' full fold; one capture per step kind and signature, no fallback."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.obs import timeseries

    stats = graphs_without_host_reads
    rng = np.random.RandomState(13)
    values = torch.from_numpy(rng.lognormal(3, 1, 300).astype(np.float32))
    scores, clicks = torch.from_numpy(rng.rand(300).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 300))
    labels = torch.from_numpy(rng.randint(0, 7, 300))
    windows = [
        (tm.Windowed(tc.BinaryAUROC(approx="sketch", sketch_bins=32, device="cpu"), 3, advance_every=1, emit=False),
         (scores, clicks)),
        (tm.Windowed(tc.MulticlassAccuracy(num_classes=7, device="cpu"), 3, advance_every=1, emit=False), (labels, labels)),
        (tm.Ema(tc.BinaryAUROC(thresholds=20, device="cpu"), decay=0.9), (scores, clicks)),
        (tm.Windowed(tm.StreamingQuantile(capacity=16, levels=8, device="cpu"), 3, advance_every=1, emit=False), (values,)),
        (tm.Windowed(tm.StreamingHistogram(bins=8, device="cpu"), 3, advance_every=1, emit=False), (scores,)),
    ]
    for metric, args in windows:
        for _ in range(2):
            metric.update(*args)
    captures = len(windows)
    for metric, _ in windows[:2]:
        metric.window_state()
        metric.window_values()
        captures += 2
    manual = tm.Windowed(ta.SumMetric(device="cpu"), 2, emit=False)
    manual.update(values)
    manual.advance()
    manual.advance()
    captures += 2
    saved = timeseries._FOLD
    timeseries._FOLD = None
    try:
        series = tm.obs.TimeSeries("capture-check", fold_every=64, device="cpu")
        for v in range(128):
            series.record(float(v))
    finally:
        timeseries._FOLD = saved
    captures += 1
    assert stats.captures == captures and not stats.fallbacks


def _image_batch(shape, seed: int = 14):
    rng = np.random.RandomState(seed)
    target = rng.rand(*shape).astype(np.float32)
    return torch.from_numpy(np.clip(target + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)), torch.from_numpy(target)


#: path P's scalar-state image classes (the graph tier's), with their batch shapes
IMAGE = {
    "P1 StructuralSimilarityIndexMeasure": (lambda: ti.StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu"), (2, 3, 32, 32)),
    "P1 StructuralSimilarityIndexMeasure data_range=None 3-D": (
        lambda: ti.StructuralSimilarityIndexMeasure(
            sigma=0.8, kernel_size=7, device="cpu"), (2, 2, 10, 12, 14)),
    "P1 MultiScaleStructuralSimilarityIndexMeasure": (
        lambda: ti.MultiScaleStructuralSimilarityIndexMeasure(
            betas=(0.3, 0.3, 0.4), device="cpu"), (2, 3, 48, 48)),
    "P1 PeakSignalNoiseRatio": (lambda: ti.PeakSignalNoiseRatio(device="cpu"), (2, 3, 16, 16)),
    "P1 PeakSignalNoiseRatioWithBlockedEffect": (lambda: ti.PeakSignalNoiseRatioWithBlockedEffect(device="cpu"), (2, 1, 24, 24)),
    "P1 UniversalImageQualityIndex": (lambda: ti.UniversalImageQualityIndex(device="cpu"), (2, 3, 24, 24)),
    "P1 VisualInformationFidelity": (lambda: ti.VisualInformationFidelity(device="cpu"), (1, 3, 48, 48)),
    "P1 TotalVariation": (lambda: ti.TotalVariation(device="cpu"), (2, 3, 16, 16)),
    "P1 RootMeanSquaredErrorUsingSlidingWindow": (lambda: ti.RootMeanSquaredErrorUsingSlidingWindow(device="cpu"), (2, 3, 16, 16)),
    "P2 SpectralAngleMapper": (lambda: ti.SpectralAngleMapper(device="cpu"), (2, 5, 16, 16)),
}


@pytest.mark.parametrize("name", sorted(IMAGE))
def test_image_update_and_compute_make_no_host_read(name):
    """Each scalar-state image class's update on the defaults, its compute and the forward's merge
    under the mode that raises on a host read or host data: the gaussian and uniform windows, the pad
    indices, PSNR-B's boundary mask and the counts are made on the device."""
    make, shape = IMAGE[name]
    m = make()
    args = _image_batch(shape)[:1] if "TotalVariation" in name else _image_batch(shape)
    defaults = m._default_state()
    assert not m._lists and m._fusable_forward()
    with _NoHostSync():
        batch_out = m._update(dict(defaults), *args)
        m._compute({k: batch_out.get(k, v) for k, v in defaults.items()})
        _merge_tensor_ladder(dict(m._tensors), batch_out, m._defaults, m._reductions, torch.ones(()))


def test_pairwise_entries_make_no_host_read():
    """Path P3's entries, which a user's captured step may call: the blocks of rows are host
    arithmetic on shapes, the products and broadcasts device work."""
    import torchmetrics_tpu_torch.functional as tf

    rng = np.random.RandomState(15)
    x, y = (torch.from_numpy(rng.randn(n, 8).astype(np.float32)) for n in (12, 9))
    with _NoHostSync():
        for name in ("cosine_similarity", "euclidean_distance", "linear_similarity", "manhattan_distance"):
            getattr(tf, "pairwise_" + name)(x, y)
            getattr(tf, "pairwise_" + name)(x, reduction="mean")
        tf.pairwise_minkowski_distance(x, y, exponent=3)


def test_image_classes_run_as_graphs_without_host_reads(graphs_without_host_reads):
    """Path P1's scalar-state classes through ``update`` (``fast_update``) and ``forward`` on the
    emulated graph tier: each step kind captured once, then replayed, with no host read inside and no
    fallback; the values equal the eager tier's."""
    from torchmetrics_tpu_torch.ops import dispatch

    stats = graphs_without_host_reads
    for name in sorted(k for k in IMAGE if k.startswith("P1")):
        make, shape = IMAGE[name]
        batches = [_image_batch(shape, seed) for seed in range(3)]
        if "TotalVariation" in name:
            batches = [b[:1] for b in batches]
        values = {}
        for tier in ("graph", "eager"):
            dispatch.EMULATE_ON_CPU = tier == "graph"
            m = make()
            m.fast_update = True
            captures, replays, fallbacks = stats.captures, stats.replays, stats.n_fallbacks
            out = [m(*batches[0]), m(*batches[1])]
            m.update(*batches[2])
            out.append(m.compute())
            if tier == "graph":
                assert stats.captures - captures == 2 and stats.replays - replays == 3, name
                assert stats.n_fallbacks == fallbacks, name
            values[tier] = [v.numpy().tobytes() for v in out]
        dispatch.EMULATE_ON_CPU = True
        assert values["graph"] == values["eager"], name


def _audio_batch(shape, seed: int = 16):
    rng = np.random.RandomState(seed)
    target = rng.randn(*shape).astype(np.float32)
    return torch.from_numpy((target + 0.3 * rng.randn(*shape)).astype(np.float32)), torch.from_numpy(target)


#: path Q3's graph-tier audio classes, with their batch shapes
AUDIO = {
    "Q3 SignalNoiseRatio": (lambda: pa.SignalNoiseRatio(device="cpu"), (3, 64)),
    "Q3 ScaleInvariantSignalDistortionRatio": (lambda: pa.ScaleInvariantSignalDistortionRatio(device="cpu"), (3, 64)),
    "Q3 ScaleInvariantSignalNoiseRatio": (lambda: pa.ScaleInvariantSignalNoiseRatio(device="cpu"), (3, 64)),
    "Q3 SourceAggregatedSignalDistortionRatio": (lambda: pa.SourceAggregatedSignalDistortionRatio(device="cpu"), (3, 2, 64)),
    "Q3 ComplexScaleInvariantSignalNoiseRatio": (lambda: pa.ComplexScaleInvariantSignalNoiseRatio(device="cpu"), (3, 5, 7, 2)),
    "Q3 SignalDistortionRatio": (lambda: pa.SignalDistortionRatio(filter_length=16, device="cpu"), (3, 64)),
    "Q3 PermutationInvariantTraining": (
        lambda: pa.PermutationInvariantTraining(pfa.scale_invariant_signal_noise_ratio, device="cpu"), (3, 2, 64)),
    "Q3 PermutationInvariantTraining permutation-wise": (
        lambda: pa.PermutationInvariantTraining(pfa.signal_noise_ratio, mode="permutation-wise", eval_func="min",
                                                device="cpu"), (3, 3, 64)),
}


@pytest.mark.parametrize("name", sorted(AUDIO))
def test_audio_update_and_compute_make_no_host_read(name, monkeypatch):
    """Each graph-tier audio class's update on the defaults, its compute and the forward's merge under
    the mode that raises on a host read or host data: SDR's Toeplitz indices come from ``arange``, its
    Cholesky solve has no check (``linalg.solve`` reads ``info`` back), PIT's permutation table is built
    on the device (here from an empty cache)."""
    from torchmetrics_tpu_torch.functional.audio import pit

    monkeypatch.setattr(pit, "_PERM_CACHE", {})
    make, shape = AUDIO[name]
    m = make()
    defaults = m._default_state()
    assert not m._lists and m._fusable_forward()
    batch = _audio_batch(shape)
    with _NoHostSync():
        batch_out = m._update(dict(defaults), *batch)
        m._compute({k: batch_out.get(k, v) for k, v in defaults.items()})
        _merge_tensor_ladder(dict(m._tensors), batch_out, m._defaults, m._reductions, torch.ones(()))


def test_audio_classes_run_as_graphs_without_host_reads(graphs_without_host_reads):
    """Path Q3's classes through ``update`` (``fast_update``) and ``forward`` on the emulated graph tier:
    each step kind captured once, then replayed, no host read inside and no fallback."""
    stats = graphs_without_host_reads
    for name in sorted(AUDIO):
        make, shape = AUDIO[name]
        m = make()
        m.fast_update = True
        captures, replays, fallbacks = stats.captures, stats.replays, stats.n_fallbacks
        m(*_audio_batch(shape, 1))
        m(*_audio_batch(shape, 2))
        m.update(*_audio_batch(shape, 3))
        m.compute()
        assert stats.captures - captures == 2 and stats.replays - replays == 3, name
        assert stats.n_fallbacks == fallbacks, name


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_update_and_compute_make_no_host_read(ignore_index):
    """Perplexity's update (the log-softmax, the gather, ``ignore_index`` as a mask and a weight) and its
    compute under the mode that raises on a host read or host data."""
    from torchmetrics_tpu_torch.text import Perplexity

    m = Perplexity(ignore_index=ignore_index, device="cpu")
    rng = np.random.RandomState(18)
    target = torch.from_numpy(rng.randint(0, 11, (2, 5)))
    if ignore_index is not None:
        target[0, :2] = ignore_index
    batch = (torch.from_numpy(rng.randn(2, 5, 11).astype(np.float32)), target)
    defaults = m._default_state()
    with _NoHostSync():
        batch_out = m._update(dict(defaults), *batch)
        m._compute({k: batch_out.get(k, v) for k, v in defaults.items()})


def test_row_scan_makes_no_host_read():
    """The Levenshtein row scan of the edit-distance metrics, as its graphs capture it: no host read and no
    tensor built from host data inside."""
    from torchmetrics_tpu_torch.functional.text import _edit

    args = tuple(torch.from_numpy(a) for a in _edit.padded_ids([list("kitten"), list("")], [list("sitting"), list("ab")]))
    with _NoHostSync():
        out = _edit.levenshtein_scan(*args, 1.0)
    assert out[:2].tolist() == [3.0, 2.0]
