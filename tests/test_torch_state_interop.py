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


def _regression(rng, n=50, outputs=1):
    shape = (n,) if outputs == 1 else (n, outputs)
    preds = rng.randn(*shape).astype(np.float32)
    return preds, (preds + rng.randn(*shape) + 2.0).astype(np.float32)


REGRESSION_CASES = [
    ("PearsonCorrCoef", {}, 1),
    ("PearsonCorrCoef", {"num_outputs": 3}, 3),
    ("ConcordanceCorrCoef", {}, 1),
    ("R2Score", {"adjusted": 2}, 1),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted"}, 3),
    ("RelativeSquaredError", {}, 1),
    ("SpearmanCorrCoef", {}, 1),
    ("SpearmanCorrCoef", {"num_outputs": 2}, 2),
    ("KendallRankCorrCoef", {"t_test": True}, 1),
]


@pytest.mark.parametrize("name,kwargs,outputs", REGRESSION_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(REGRESSION_CASES)])
def test_jax_regression_state_loads_and_computes_the_same(name, kwargs, outputs):
    """float32 sums and moments stay float32, ``cat`` entries load as lists; rtol 1e-5, as the
    regression computes hold to the JAX package."""
    pytest.importorskip("jax")
    import torchmetrics_tpu.regression as jr

    import torchmetrics_tpu_torch.regression as tr

    rng = np.random.RandomState(len(name) + outputs)
    theirs = jr.__dict__[name](**kwargs)
    for _ in range(3):
        theirs.update(*_regression(rng, outputs=outputs))
    arrays = {k: [np.asarray(e) for e in v] if isinstance(v, list) else np.asarray(v)
              for k, v in theirs.metric_state.items()}
    ours = load_numpy_state(getattr(tr, name)(device="cpu", **kwargs), arrays)
    for key, value in ours.metric_state.items():
        assert isinstance(value, list) == isinstance(arrays[key], list), key
        for entry in value if isinstance(value, list) else [value]:
            assert entry.dtype == torch.float32, key
    got, want = ours.compute(), theirs.compute()
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("outputs", [1, 3])
def test_pearson_states_with_a_world_axis(outputs):
    """Pearson's six states stacked over three replicas (as sync hands them) keep their leading world
    axis when loaded, and the compute folds it with ``_final_aggregation``: the JAX package's value."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import torchmetrics_tpu.regression as jr

    import torchmetrics_tpu_torch.regression as tr

    rng = np.random.RandomState(outputs)
    kwargs = {} if outputs == 1 else {"num_outputs": outputs}
    replicas = []
    for _ in range(3):
        m = jr.PearsonCorrCoef(**kwargs)
        for _ in range(2):
            m.update(*_regression(rng, outputs=outputs))
        replicas.append({k: np.asarray(v) for k, v in m.metric_state.items()})
    stacked = {k: np.stack([r[k] for r in replicas]) for k in replicas[0]}
    ours = load_numpy_state(tr.PearsonCorrCoef(device="cpu", **kwargs), stacked)
    assert ours.metric_state["n_total"].shape == (3,)
    assert ours.metric_state["mean_x"].shape == ((3,) if outputs == 1 else (3, outputs))
    theirs = jr.PearsonCorrCoef(**kwargs)
    want = theirs._compute({k: jnp.asarray(v) for k, v in stacked.items()})
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_synced_pearson_state_from_the_jax_package():
    """JAX's replica 0 synced over a world of two (``sync`` without ``unsync``): its states carry
    the world axis, load as they are, and give JAX's synced value."""
    pytest.importorskip("jax")
    import torchmetrics_tpu.regression as jr

    import torchmetrics_tpu_torch.regression as tr

    rng = np.random.RandomState(37)
    replicas = [jr.PearsonCorrCoef() for _ in range(2)]
    for m, n in zip(replicas, (37, 63)):
        m.update(*_regression(rng, n=n))
    states = [r._state.snapshot() for r in replicas]
    replicas[0].sync(dist_sync_fn=lambda v, g=None, name=None: [s[name] for s in states], distributed_available=lambda: True)
    arrays = {k: np.asarray(v) for k, v in replicas[0].metric_state.items()}
    assert arrays["n_total"].shape == (2,)
    want = replicas[0]._compute(replicas[0]._computable_state())
    ours = load_numpy_state(tr.PearsonCorrCoef(device="cpu"), arrays)
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _wrapper_pair(name):
    import torchmetrics_tpu.aggregation as ja
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.regression as jr
    import torchmetrics_tpu.wrappers as jw

    import torchmetrics_tpu_torch.aggregation as ta
    import torchmetrics_tpu_torch.regression as tr
    import torchmetrics_tpu_torch.wrappers as tw

    if name == "BootStrapper":
        return (jw.BootStrapper(jc.BinaryAccuracy(), num_bootstraps=4, seed=3, raw=True),
                tw.BootStrapper(tc.BinaryAccuracy(device="cpu"), num_bootstraps=4, seed=3, raw=True))
    if name == "MultioutputWrapper":
        return (jw.MultioutputWrapper(jr.MeanSquaredError(), num_outputs=3),
                tw.MultioutputWrapper(tr.MeanSquaredError(device="cpu"), num_outputs=3))
    if name == "ClasswiseWrapper":
        return (jw.ClasswiseWrapper(jc.MulticlassAccuracy(num_classes=4, average=None)),
                tw.ClasswiseWrapper(tc.MulticlassAccuracy(num_classes=4, average=None, device="cpu")))
    return jw.MinMaxMetric(ja.MeanMetric()), tw.MinMaxMetric(ta.MeanMetric(device="cpu"))


def _state(m):
    return {k: [np.asarray(e) for e in v] if isinstance(v, list) else np.asarray(v) for k, v in m.metric_state.items()}


@pytest.mark.parametrize("name", ["BootStrapper", "MultioutputWrapper", "ClasswiseWrapper", "MinMaxMetric"])
def test_wrapper_states_load(name):
    """Each wrapped copy's state, and ``MinMaxMetric``'s running extremes, carried across under the
    JAX package's attribute names; the port's ``compute()`` gives JAX's value."""
    pytest.importorskip("jax")
    theirs, ours = _wrapper_pair(name)
    rng = np.random.RandomState(len(name))
    for step in range(3):
        if name == "BootStrapper":
            theirs.update(*_binary(rng))
        elif name == "MultioutputWrapper":
            theirs.update(*_regression(rng, outputs=3))
        elif name == "ClasswiseWrapper":
            theirs.update(*_multiclass(rng))
        else:
            theirs.update(rng.rand(10).astype(np.float32))
            theirs.compute()  # moves the running extremes
    if name in ("BootStrapper", "MultioutputWrapper"):
        arrays = {"metrics": [_state(m) for m in theirs.metrics]}
    elif name == "ClasswiseWrapper":
        arrays = {"metric": _state(theirs.metric)}
    else:
        arrays = {"_base_metric": _state(theirs._base_metric), "min_val": np.asarray(theirs.min_val),
                  "max_val": np.asarray(theirs.max_val)}
    load_numpy_state(ours, arrays)
    got, want = ours.compute(), theirs.compute()
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    with pytest.raises(KeyError, match="takes no state"):
        load_numpy_state(ours, {"unknown": np.zeros(1)})


def _clustering_nominal_batch(kind, rng, n=60):
    if kind == "labels":
        target = rng.randint(0, 5, n) * 2 - 3
        return np.where(rng.rand(n) < 0.6, target, rng.randint(-3, 9, n)), target
    if kind == "data":
        labels = rng.randint(0, 4, n)
        return (rng.randn(n, 3) + 3 * labels[:, None]).astype(np.float32), labels
    if kind == "nominal":
        preds, target = rng.randint(0, 5, n).astype(np.float32), rng.randint(0, 5, n).astype(np.float32)
        preds[rng.rand(n) < 0.1] = np.nan
        return preds, target
    if kind == "probs":
        return (rng.rand(n, 4, 3).astype(np.float32),)
    return (rng.randint(0, 4, (n, 4)),)


CLUSTERING_NOMINAL_CASES = [
    *((name, {}, "labels") for name in ("MutualInfoScore", "RandScore", "AdjustedRandScore", "AdjustedMutualInfoScore",
                                        "NormalizedMutualInfoScore", "FowlkesMallowsIndex", "HomogeneityScore",
                                        "CompletenessScore", "VMeasureScore")),
    *((name, {}, "data") for name in ("CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex")),
    ("CramersV", {"num_classes": 5}, "nominal"),
    ("PearsonsContingencyCoefficient", {"num_classes": 5, "nan_strategy": "drop"}, "nominal"),
    ("TheilsU", {"num_classes": 5}, "nominal"),
    ("TschuprowsT", {"num_classes": 5, "bias_correction": False}, "nominal"),
    ("FleissKappa", {"mode": "probs"}, "probs"),
    ("FleissKappa", {"mode": "counts"}, "counts"),
]


@pytest.mark.parametrize("name,kwargs,kind", CLUSTERING_NOMINAL_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CLUSTERING_NOMINAL_CASES)])
def test_jax_clustering_and_nominal_state_loads_and_computes_the_same(name, kwargs, kind):
    """The label, data and count ``cat`` entries load as lists in their own dtypes, the nominal
    confmat as float32; the port's ``compute()`` gives JAX's value within 1e-5 (AMI 1e-4: the
    port's expected MI is float64, ROADMAP queue C)."""
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt

    import torchmetrics_tpu_torch as tt

    rng = np.random.RandomState(len(name) + len(kind))
    theirs = getattr(jt, name)(**kwargs)
    for _ in range(3):
        theirs.update(*_clustering_nominal_batch(kind, rng))
    arrays = _state(theirs)
    ours = load_numpy_state(getattr(tt, name)(device="cpu", **kwargs), arrays)
    for key, value in ours.metric_state.items():
        assert isinstance(value, list) == isinstance(arrays[key], list), key
        if not isinstance(value, list):
            assert value.dtype == torch.float32, key
    rtol = 1e-4 if name == "AdjustedMutualInfoScore" else 1e-5
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=rtol, atol=rtol / 10)


# ------------------------------------------------------------------ sketches, retrieval's sketch mode, keyed tables
SKETCH_KEYED_CASES = ["StreamingQuantile", "StreamingHistogram", "RetrievalMAP-sketch", "KeyedMetric-Sum",
                      "KeyedMetric-StreamingQuantile", "KeyedMetric-BinaryAUROC-sketch"]


def _sketch_keyed_pair(case):
    """(JAX metric, a fresh port metric of the same configuration, the batches to feed the JAX one)."""
    import torchmetrics_tpu as jt
    import torchmetrics_tpu.classification as jc

    import torchmetrics_tpu_torch as tt

    rng = np.random.RandomState(len(case))
    cpu = {"device": "cpu"}
    if case.startswith("Streaming"):
        kw = {"q": (0.1, 0.5, 0.9)} if case == "StreamingQuantile" else {"bins": 16}
        batches = [(rng.normal(0.5, 0.3, 700).astype(np.float32),) for _ in range(3)]
        return getattr(jt, case)(**kw), getattr(tt, case)(**kw, **cpu), batches
    if case == "RetrievalMAP-sketch":
        batches = [(rng.rand(60).astype(np.float32), rng.randint(0, 2, 60), np.repeat(np.arange(10 * i, 10 * i + 10), 6))
                   for i in range(3)]
        return jt.RetrievalMAP(approx="sketch"), tt.RetrievalMAP(approx="sketch", **cpu), batches
    ids = [rng.randint(0, 5, 40).astype(np.int32) for _ in range(3)]
    if case == "KeyedMetric-Sum":
        return (jt.KeyedMetric(jt.SumMetric(), 5), tt.KeyedMetric(tt.SumMetric(**cpu), 5),
                [(i, rng.randint(-5, 6, 40).astype(np.float32)) for i in ids])
    if case == "KeyedMetric-StreamingQuantile":
        kw = {"capacity": 8, "levels": 6}
        return (jt.KeyedMetric(jt.StreamingQuantile(**kw), 5), tt.KeyedMetric(tt.StreamingQuantile(**kw, **cpu), 5),
                [(i, rng.rand(40).astype(np.float32)) for i in ids])
    kw = {"approx": "sketch", "sketch_bins": 32}
    return (jt.KeyedMetric(jc.BinaryAUROC(**kw), 5), tt.KeyedMetric(tt.classification.BinaryAUROC(**kw, **cpu), 5),
            [(i, rng.rand(40).astype(np.float32), rng.randint(0, 2, 40)) for i in ids])


@pytest.mark.parametrize("case", SKETCH_KEYED_CASES)
def test_jax_sketch_and_keyed_states_load_and_compute_the_same(case):
    """A JAX KLL state, a histogram, retrieval's sketch states (count-min included) and keyed tables
    load as float32 and give JAX's value: the KLL quantiles and the keyed tables exactly."""
    pytest.importorskip("jax")
    theirs, ours, batches = _sketch_keyed_pair(case)
    for batch in batches:
        if case.startswith("Retrieval"):
            theirs.update(*batch[:2], indexes=batch[2])
        else:
            theirs.update(*batch)
    arrays = _state(theirs)
    load_numpy_state(ours, arrays)
    for key, value in ours.metric_state.items():
        assert value.dtype == torch.float32 and value.numpy().tobytes() == arrays[key].tobytes(), key
    want = np.asarray(theirs.compute())
    got = ours.compute().numpy()
    if case.startswith("Retrieval") or case.endswith("AUROC-sketch"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert got.tobytes() == want.tobytes()


# ------------------------------------------------------------------ image quality
IMAGE_CASES = [
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0}, (2, 3, 32, 32)),
    ("StructuralSimilarityIndexMeasure", {"reduction": "none", "return_contrast_sensitivity": True}, (2, 1, 32, 32)),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (0.5, 0.5)}, (2, 3, 32, 32)),
    ("PeakSignalNoiseRatio", {}, (2, 3, 16, 16)),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, (2, 3, 16, 16)),
    ("PeakSignalNoiseRatioWithBlockedEffect", {}, (2, 1, 16, 16)),
    ("UniversalImageQualityIndex", {}, (2, 3, 32, 32)),
    ("UniversalImageQualityIndex", {"reduction": "none"}, (2, 1, 32, 32)),
    ("SpectralAngleMapper", {}, (2, 4, 16, 16)),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {}, (2, 4, 16, 16)),
    ("RelativeAverageSpectralError", {}, (2, 3, 16, 16)),
    ("RootMeanSquaredErrorUsingSlidingWindow", {}, (2, 3, 16, 16)),
    ("SpectralDistortionIndex", {}, (2, 4, 16, 16)),
    ("TotalVariation", {"reduction": "mean"}, (2, 3, 16, 16)),
    ("TotalVariation", {"reduction": "none"}, (2, 3, 16, 16)),
    ("VisualInformationFidelity", {}, (1, 2, 48, 48)),
]


@pytest.mark.parametrize("name,kwargs,shape", IMAGE_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(IMAGE_CASES)])
def test_jax_image_states_load_and_compute_the_same(name, kwargs, shape):
    """Every image state: the float32 sums, PSNR's zero-initialised extremes and PSNR-B's ``max``-reduced
    range, the ``cat`` entries as lists, and TV's int32 image count, which becomes the port's int64
    count; the port's ``compute()`` gives JAX's value within rtol 1e-5 (the windowed means 1e-5 absolute)."""
    pytest.importorskip("jax")
    import torchmetrics_tpu.image as ji

    import torchmetrics_tpu_torch.image as ti

    rng = np.random.RandomState(len(name) + len(kwargs))
    theirs = getattr(ji, name)(**kwargs)
    for _ in range(2):
        target = rng.rand(*shape).astype(np.float32)
        preds = np.clip(target + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
        theirs.update(*((preds,) if name == "TotalVariation" else (preds, target)))
    arrays = _state(theirs)
    ours = load_numpy_state(getattr(ti, name)(device="cpu", **kwargs), arrays)
    for key, value in ours.metric_state.items():
        assert isinstance(value, list) == isinstance(arrays[key], list), key
        if not isinstance(value, list):
            assert value.dtype == (torch.int64 if key == "num_elements" else torch.float32), key
    for got, want in zip(*(v if isinstance(v, tuple) else (v,) for v in (ours.compute(), theirs.compute()))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


#: the generative and audio classes whose states a JAX run hands over: (name, JAX constructor, port
#: constructor, the update batches as (args, kwargs))
def _generative_audio_case(case):
    rng = np.random.RandomState(len(case))
    feats = [rng.randn(40, 8).astype(np.float32) + shift for shift in (0.0, 0.5)]
    signals = [(rng.randn(3, 2, 200).astype(np.float32), rng.randn(3, 2, 200).astype(np.float32)) for _ in range(2)]
    net = _TinyDistance()
    if case == "FrechetInceptionDistance":
        kwargs = {"feature": None, "num_features": 8}
        return kwargs, kwargs, [((feats[0],), {"real": True}), ((feats[1],), {"real": False})]
    if case in ("KernelInceptionDistance", "MemorizationInformedFrechetInceptionDistance"):
        kwargs = {"feature": None, "subsets": 3, "subset_size": 20, "seed": 1} if case[0] == "K" else {"feature": None}
        return kwargs, kwargs, [((feats[0],), {"real": True}), ((feats[1],), {"real": False})]
    if case == "InceptionScore":
        kwargs = {"feature": None, "splits": 2, "seed": 0}
        return kwargs, kwargs, [((feats[0],), {}), ((feats[1],), {})]
    if case == "LearnedPerceptualImagePatchSimilarity":
        imgs = [(rng.rand(2, 3, 8, 8).astype(np.float32), rng.rand(2, 3, 8, 8).astype(np.float32)) for _ in range(2)]
        return ({"net_type": lambda a, b: net(torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b))).numpy()},
                {"net_type": net}, [(pair, {}) for pair in imgs])
    if case == "PermutationInvariantTraining":
        return ({"metric_func": "signal_noise_ratio"}, {"metric_func": "signal_noise_ratio"}, [(s, {}) for s in signals])
    return {}, {}, [(s, {}) for s in signals]


class _TinyDistance(torch.nn.Module):
    def __init__(self) -> None:
        super().__init__()
        torch.manual_seed(2)
        self.conv = torch.nn.Conv2d(3, 4, 3)

    def forward(self, a, b):
        with torch.no_grad():
            return ((self.conv(a) - self.conv(b)) ** 2).mean(dim=(1, 2, 3))


GENERATIVE_AUDIO_CASES = ["FrechetInceptionDistance", "KernelInceptionDistance", "InceptionScore",
                          "MemorizationInformedFrechetInceptionDistance", "LearnedPerceptualImagePatchSimilarity",
                          "SignalNoiseRatio", "ScaleInvariantSignalDistortionRatio", "SourceAggregatedSignalDistortionRatio",
                          "PermutationInvariantTraining"]


@pytest.mark.parametrize("name", GENERATIVE_AUDIO_CASES)
def test_jax_generative_and_audio_states_load_and_compute_the_same(name):
    """FID's 14 float32 states (the compensated sums and the counts), KID's and MiFID's ``real``/``fake``
    lists, IS's list, LPIPS's sums and the audio classes' ``sum_metric``/``total`` load from a JAX run;
    the port's ``compute()`` gives JAX's value within rtol 1e-5 (FID and MiFID, which the port computes
    in float64 from the same float32 states, within 1e-4)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.audio as ja
    import torchmetrics_tpu.functional.audio as jfa
    import torchmetrics_tpu.image as ji

    import torchmetrics_tpu_torch.audio as pa
    import torchmetrics_tpu_torch.functional.audio as pfa
    import torchmetrics_tpu_torch.image as pi

    jax_kwargs, port_kwargs, batches = _generative_audio_case(name)
    if "metric_func" in jax_kwargs:
        jax_kwargs = {**jax_kwargs, "metric_func": getattr(jfa, jax_kwargs["metric_func"])}
        port_kwargs = {**port_kwargs, "metric_func": getattr(pfa, port_kwargs["metric_func"])}
    theirs = getattr(ji if hasattr(ji, name) else ja, name)(**jax_kwargs)
    for args, kwargs in batches:
        theirs.update(*(jnp.asarray(a) for a in args), **kwargs)
    arrays = _state(theirs)
    if name == "FrechetInceptionDistance":
        assert len(arrays) == 14
    ours = load_numpy_state(getattr(pi if hasattr(pi, name) else pa, name)(device="cpu", **port_kwargs), arrays)
    for key, value in ours.metric_state.items():
        assert isinstance(value, list) == isinstance(arrays[key], list), key
        for v in value if isinstance(value, list) else [value]:
            assert v.dtype == torch.float32, key
    rtol = 1e-4 if name in ("FrechetInceptionDistance", "MemorizationInformedFrechetInceptionDistance") else 1e-5
    for got, want in zip(*(v if isinstance(v, tuple) else (v,) for v in (ours.compute(), theirs.compute()))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-6)
