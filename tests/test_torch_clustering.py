"""The port's clustering (``functional/clustering``, ``clustering/``) against the JAX package.

The same seeded numpy inputs go through the JAX package and through the port on the CPU, where K1
takes its plain version. The contingency table, the pair confusion matrix and the label counts are
held equal exactly; every score within 1e-5 relative, the adjusted mutual information within 1e-4:
the port sums the expected mutual information in float64, the JAX package in float32 (``ROADMAP.md``
queue C), and ``test_expected_mutual_info_in_float64`` pins that difference against a float64
numpy/scipy oracle written here. Label sets cover gapped and negative ids, float-integral labels, a
single cluster on either side or both, perfect agreement and no samples; every ``average_method``,
``beta`` and Dunn's ``p``; the validators raise as the JAX package's do. JAX is imported inside
fixtures, so that the card test runs where there is no JAX.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.special import gammaln

import torchmetrics_tpu_torch as port
import torchmetrics_tpu_torch.functional.clustering as pfc
from torchmetrics_tpu_torch.functional.clustering import extrinsic, utils

EXTRINSIC = ["mutual_info_score", "rand_score", "adjusted_rand_score", "adjusted_mutual_info_score",
             "normalized_mutual_info_score", "fowlkes_mallows_index", "homogeneity_score", "completeness_score",
             "v_measure_score"]
CLASSES = {"mutual_info_score": "MutualInfoScore", "rand_score": "RandScore", "adjusted_rand_score": "AdjustedRandScore",
           "adjusted_mutual_info_score": "AdjustedMutualInfoScore",
           "normalized_mutual_info_score": "NormalizedMutualInfoScore", "fowlkes_mallows_index": "FowlkesMallowsIndex",
           "homogeneity_score": "HomogeneityScore", "completeness_score": "CompletenessScore",
           "v_measure_score": "VMeasureScore"}
TOL = 1e-5
AMI_TOL = 1e-4


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    import torchmetrics_tpu.functional.clustering as jfc
    from torchmetrics_tpu.functional.clustering import utils as jutils

    return SimpleNamespace(top=jt, fc=jfc, utils=jutils)


def _rtol(name: str) -> float:
    return AMI_TOL if "adjusted_mutual" in name else TOL


def _close(ours, theirs, rtol=TOL):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64), rtol=rtol, atol=rtol)


def _labels(case: str, n: int = 600, seed: int = 0):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, 9, n)
    preds = np.where(rng.rand(n) < 0.6, target, rng.randint(0, 12, n))
    if case == "gapped_negative":
        return preds * 7 - 20, target * 3 - 11
    if case == "float_integral":
        return (preds * 2.0 - 5.0).astype(np.float32), (target + 0.0).astype(np.float64)
    if case == "single_target":
        return preds, np.full(n, 4)
    if case == "single_preds":
        return np.full(n, -2), target
    if case == "single_both":
        return np.full(n, 1), np.full(n, 1)
    if case == "perfect":
        return target * 5, target
    if case == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if case == "int32_wide":
        return (preds * 100_003).astype(np.int64), target.astype(np.int32)
    return preds, target


LABEL_CASES = ["plain", "gapped_negative", "float_integral", "single_target", "single_preds", "single_both", "perfect",
               "empty", "int32_wide"]


# ------------------------------------------------------------------ shared steps
@pytest.mark.parametrize("case", LABEL_CASES)
def test_contingency_pair_matrix_and_relabel_exact(jax, case):
    preds, target = _labels(case)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    ours = utils.calculate_contingency_matrix(p, t)
    theirs = np.asarray(jax.utils.calculate_contingency_matrix(preds, target))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    pair = utils.calculate_pair_cluster_confusion_matrix(p, t)
    np.testing.assert_array_equal(pair.numpy(), np.asarray(jax.utils.calculate_pair_cluster_confusion_matrix(preds, target)))
    codes, k = utils.relabel(t)
    want_codes, want_k = jax.utils.relabel(target)
    assert k == want_k
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))


@pytest.mark.parametrize("case", ["plain", "gapped_negative", "float_integral", "single_target", "empty"])
def test_entropy(jax, case):
    _, target = _labels(case)
    _close(utils.calculate_entropy(torch.from_numpy(target)), jax.utils.calculate_entropy(target))


@pytest.mark.parametrize("p", ["min", "geometric", "arithmetic", "max", 2, 0.5, -1])
def test_generalized_mean(jax, p):
    x = np.array([0.3, 1.7, 0.9], np.float32)
    _close(utils.calculate_generalized_mean(torch.from_numpy(x), p), jax.utils.calculate_generalized_mean(x, p))


def test_pair_matrix_argument_errors(jax):
    c = torch.ones(2, 2, dtype=torch.int32)
    for kwargs in ({}, {"preds": c[0], "target": c[0], "contingency": c}, {"preds": c[0]}):
        with pytest.raises(ValueError) as ours:
            utils.calculate_pair_cluster_confusion_matrix(**kwargs)
        with pytest.raises(ValueError) as theirs:
            jax.utils.calculate_pair_cluster_confusion_matrix(**{k: np.asarray(v) for k, v in kwargs.items()})
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="'method' must be"):
        utils.calculate_generalized_mean(torch.ones(2), "median")


# ------------------------------------------------------------------ extrinsic scores
@pytest.mark.parametrize("case", LABEL_CASES)
@pytest.mark.parametrize("name", EXTRINSIC)
def test_extrinsic_functional(jax, name, case):
    preds, target = _labels(case)
    ours = getattr(pfc, name)(torch.from_numpy(preds), torch.from_numpy(target))
    assert ours.dtype == torch.float32 and ours.shape == ()
    _close(ours, getattr(jax.fc, name)(preds, target), _rtol(name))


@pytest.mark.parametrize("average_method", ["min", "geometric", "arithmetic", "max"])
@pytest.mark.parametrize("name", ["adjusted_mutual_info_score", "normalized_mutual_info_score"])
def test_average_methods(jax, name, average_method):
    preds, target = _labels("gapped_negative", seed=3)
    ours = getattr(pfc, name)(torch.from_numpy(preds), torch.from_numpy(target), average_method)
    _close(ours, getattr(jax.fc, name)(preds, target, average_method), _rtol(name))


@pytest.mark.parametrize("beta", [0.5, 1.0, 2, 7.5])
def test_v_measure_beta(jax, beta):
    preds, target = _labels("plain", seed=4)
    _close(pfc.v_measure_score(torch.from_numpy(preds), torch.from_numpy(target), beta),
           jax.fc.v_measure_score(preds, target, beta))


def test_nmi_of_independent_clusterings_returns_mi(jax):
    """NMI's host read: an MI within float32's epsilon of 0 is returned as it is."""
    target = np.repeat(np.arange(4), 25)
    preds = np.tile(np.arange(5), 20)
    ours = pfc.normalized_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target))
    assert abs(float(ours)) <= np.finfo(np.float32).eps
    _close(ours, jax.fc.normalized_mutual_info_score(preds, target))


@pytest.mark.parametrize("bad", ["ndim", "shape", "non_integral_preds", "non_integral_target", "nan", "complex"])
def test_label_validation_as_jax(jax, bad):
    preds, target = _labels("plain", n=20)
    if bad == "ndim":
        preds = preds.reshape(4, 5)
    elif bad == "shape":
        preds = preds[:-1]
    elif bad == "non_integral_preds":
        preds = preds + 0.5
    elif bad == "non_integral_target":
        target = target.astype(np.float32)
        target[3] = 0.25
    elif bad == "nan":
        preds = preds.astype(np.float64)
        preds[0] = np.nan
    else:
        preds = preds.astype(np.complex64)
    with pytest.raises(ValueError) as theirs:
        jax.fc.mutual_info_score(preds, target)
    with pytest.raises(ValueError) as ours:
        pfc.mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target))
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ the float64 expected mutual information
def emi_float64(contingency: np.ndarray) -> float:
    """sklearn's definition of the expected MI, written out in float64 numpy with scipy's ``gammaln``."""
    c = np.asarray(contingency, np.int64)
    a, b = c.sum(1), c.sum(0)
    n = int(c.sum())
    if len(a) == 1 or len(b) == 1:
        return 0.0
    ai, bj = np.repeat(a, len(b)), np.tile(b, len(a))
    lo = np.maximum(1, ai + bj - n)
    count = np.maximum(np.minimum(ai, bj) - lo + 1, 0)
    cell = np.repeat(np.arange(len(ai)), count)
    nij = lo[cell] + np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
    A, B = ai[cell].astype(np.float64), bj[cell].astype(np.float64)
    x = nij.astype(np.float64)
    gln = (gammaln(A + 1) + gammaln(B + 1) + gammaln(n - A + 1) + gammaln(n - B + 1) - gammaln(n + 1.0)
           - gammaln(x + 1) - gammaln(A - x + 1) - gammaln(B - x + 1) - gammaln(n - A - B + x + 1))
    return float(np.sum(x / n * (math.log(n) + np.log(x) - np.log(A) - np.log(B)) * np.exp(gln)))


def test_expected_mutual_info_in_float64(jax):
    """At n = 20,000 and 20 clusters agreeing on 60% of samples: the port's EMI within 1e-6 relative
    of the float64 oracle (it is 4.8e-9 away), the JAX package's float32 sum 2.4% away from it."""
    rng = np.random.RandomState(0)
    target = rng.randint(0, 20, 20_000)
    preds = np.where(rng.rand(20_000) < 0.6, target, rng.randint(0, 20, 20_000))
    contingency = utils.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    want = emi_float64(contingency.numpy())
    ours = float(pfc.expected_mutual_info_score(contingency, 20_000))
    theirs = float(jax.fc.expected_mutual_info_score(jax.utils.calculate_contingency_matrix(preds, target), 20_000))
    assert abs(ours - want) <= 1e-6 * want
    assert 0.02 * want < abs(theirs - want) < 0.03 * want, (theirs, want)
    ami = pfc.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target))
    mi = float(pfc.mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target)))
    h = [float(utils.calculate_entropy(torch.from_numpy(x))) for x in (preds, target)]
    _close(ami, (mi - want) / (np.mean(h) - want), 1e-5)


@pytest.mark.parametrize("n", [2, 3, 5, 10, 50])
@pytest.mark.parametrize("average_method", ["arithmetic", "min"])
def test_ami_of_identical_singleton_labelings_is_one(jax, n, average_method):
    """Every label a singleton on both sides, the same partition (queue C, C4): MI, the normaliser and the
    EMI all equal log n, so the score is noise over noise; JAX and scikit-learn give 1.0, as the port
    does for two labelings that are the same partition. The module class agrees."""
    preds, target = np.arange(n), np.arange(n)[::-1].copy()
    ours = pfc.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target), average_method)
    assert float(ours) == float(jax.fc.adjusted_mutual_info_score(preds, target, average_method)) == 1.0
    sklearn = pytest.importorskip("sklearn.metrics")
    assert sklearn.adjusted_mutual_info_score(target, preds, average_method=average_method) == 1.0
    metric = port.AdjustedMutualInfoScore(average_method, device="cpu")
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert float(metric.compute()) == 1.0


@pytest.mark.parametrize("chunk", [1, 7, 1 << 22])
def test_expected_mutual_info_chunks(monkeypatch, chunk):
    """The sum split into passes of any size gives the oracle's value; ragged cell ranges included."""
    monkeypatch.setattr(extrinsic, "EMI_CHUNK_TERMS", chunk)
    rng = np.random.RandomState(5)
    sizes = rng.randint(1, 40, 7)
    target = np.repeat(np.arange(7), sizes)
    preds = rng.randint(0, 4, target.size)
    contingency = utils.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    got = float(pfc.expected_mutual_info_score(contingency, target.size))
    assert abs(got - emi_float64(contingency.numpy())) <= 1e-6 * abs(emi_float64(contingency.numpy()))


# ------------------------------------------------------------------ intrinsic scores
def _data(n=300, k=6, d=5, seed=1):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, k, n)
    centres = rng.randn(k, d) * 4
    return (centres[labels] + rng.randn(n, d)).astype(np.float32), labels * 3 - 4


@pytest.mark.parametrize("name", ["calinski_harabasz_score", "davies_bouldin_score", "dunn_index"])
@pytest.mark.parametrize("shape", [(300, 6, 5), (50, 2, 1), (1000, 40, 16)])
def test_intrinsic_functional(jax, name, shape):
    data, labels = _data(*shape)
    ours = getattr(pfc, name)(torch.from_numpy(data), torch.from_numpy(labels))
    _close(ours, getattr(jax.fc, name)(data, labels))


@pytest.mark.parametrize("p", [1, 2, 3, 0.5, float("inf")])
def test_dunn_p(jax, p):
    data, labels = _data(seed=2)
    _close(pfc.dunn_index(torch.from_numpy(data), torch.from_numpy(labels), p), jax.fc.dunn_index(data, labels, p))


def test_intrinsic_degenerate_cases(jax):
    """Every sample at its centroid: CH 1.0 and DB 0.0 by the degenerate branches, in both."""
    labels = np.repeat([0, 1, 2], 4)
    data = np.repeat(np.array([[0.0, 1.0], [2.0, 2.0], [5.0, -1.0]], np.float32), 4, axis=0)
    for name in ("calinski_harabasz_score", "davies_bouldin_score"):
        _close(getattr(pfc, name)(torch.from_numpy(data), torch.from_numpy(labels)), getattr(jax.fc, name)(data, labels))


@pytest.mark.parametrize("bad", ["data_1d", "data_int", "labels_2d", "one_cluster", "all_clusters"])
@pytest.mark.parametrize("name", ["calinski_harabasz_score", "davies_bouldin_score"])
def test_intrinsic_validation_as_jax(jax, name, bad):
    data, labels = _data(n=30)
    if bad == "data_1d":
        data = data[:, 0]
    elif bad == "data_int":
        data = data.astype(np.int32)
    elif bad == "labels_2d":
        labels = labels.reshape(15, 2)
    elif bad == "one_cluster":
        labels = np.zeros(30, np.int64)
    else:
        labels = np.arange(30)
    with pytest.raises(ValueError) as theirs:
        getattr(jax.fc, name)(data, labels)
    with pytest.raises(ValueError) as ours:
        getattr(pfc, name)(torch.from_numpy(data), torch.from_numpy(labels))
    assert str(ours.value) == str(theirs.value)


def test_dunn_single_cluster_raises_in_both(jax):
    data, _ = _data(n=20)
    labels = np.zeros(20, np.int64)
    with pytest.raises(ValueError):
        jax.fc.dunn_index(data, labels)
    with pytest.raises(ValueError, match="two clusters"):
        pfc.dunn_index(torch.from_numpy(data), torch.from_numpy(labels))


def test_cluster_sums_are_sorted_segment_sums():
    """The centroids are each cluster's rows summed in row order (``segment_reduce``), bit for bit
    a float32 loop over the sorted rows."""
    from torchmetrics_tpu_torch.functional.clustering.intrinsic import _cluster_stats

    data, labels = _data(n=200, k=5, d=3, seed=7)
    idx, k = utils.relabel(torch.from_numpy(labels))
    counts, centroids, _, _ = _cluster_stats(torch.from_numpy(data), idx, k)
    for c in range(k):
        rows = data[idx.numpy() == c]
        acc = np.zeros(3, np.float32)
        for r in rows:
            acc = acc + r
        assert counts[c] == len(rows)
        np.testing.assert_array_equal(centroids[c].numpy(), acc / np.float32(len(rows)))


# ------------------------------------------------------------------ the classes
def _class_batches(name: str, seed: int):
    if name in ("CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex"):
        data, labels = _data(n=240, seed=seed)
        return [(data[i:i + 80], labels[i:i + 80]) for i in range(0, 240, 80)]
    preds, target = _labels("gapped_negative", n=240, seed=seed)
    return [(preds[i:i + 80], target[i:i + 80]) for i in range(0, 240, 80)]


CLASS_CASES = [(c, {}) for c in CLASSES.values()] + [
    ("AdjustedMutualInfoScore", {"average_method": "max"}), ("NormalizedMutualInfoScore", {"average_method": "geometric"}),
    ("VMeasureScore", {"beta": 2.0}), ("CalinskiHarabaszScore", {}), ("DaviesBouldinScore", {}), ("DunnIndex", {}),
    ("DunnIndex", {"p": 1}),
]


@pytest.mark.parametrize("name,kwargs", CLASS_CASES, ids=[f"{c}-{i}" for i, (c, _) in enumerate(CLASS_CASES)])
def test_class_against_jax(jax, name, kwargs):
    """``forward`` three batches (each batch value against JAX's), then ``compute`` over all."""
    batches = _class_batches(name, seed=len(name))
    ours, theirs = getattr(port, name)(device="cpu", **kwargs), getattr(jax.top, name)(**kwargs)
    rtol = AMI_TOL if name == "AdjustedMutualInfoScore" else TOL
    for batch in batches:
        _close(ours(*(torch.from_numpy(a) for a in batch)), theirs(*batch), rtol)
    _close(ours.compute(), theirs.compute(), rtol)
    assert len(ours.metric_state[next(iter(ours.metric_state))]) == 3


def test_class_arguments_as_jax(jax):
    for name, kwargs in (("AdjustedMutualInfoScore", {"average_method": "mean"}),
                         ("NormalizedMutualInfoScore", {"average_method": "median"}), ("VMeasureScore", {"beta": 0}),
                         ("VMeasureScore", {"beta": "1"})):
        with pytest.raises(ValueError) as theirs:
            getattr(jax.top, name)(**kwargs)
        with pytest.raises(ValueError) as ours:
            getattr(port, name)(device="cpu", **kwargs)
        assert str(ours.value) == str(theirs.value)


def test_classes_stay_eager_on_the_graph_tier(monkeypatch):
    """With the update-only graph tier asked for (``fast_update``), every step stays eager on the
    emulated graph tier: no capture, and the gate notes why (``jit_update_off``), as path M asserts
    on the card."""
    from torchmetrics_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    dispatch.STATS.reset()
    m = port.AdjustedRandScore(device="cpu")
    m.fast_update = True
    preds, target = _labels("plain", n=100)
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    m(torch.from_numpy(preds), torch.from_numpy(target))
    m.compute()
    assert dispatch.STATS.captures == 0
    assert any(key[-1] == "jit_update_off" for key in dispatch.STATS.fallbacks)


@pytest.mark.cuda
def test_on_the_card():
    """On the card: every entry's value equals the CPU run's within 1e-5 (relative), the
    contingency table is K1's (launches counted) and equals the CPU's exactly. Run there with
    ``python -m pytest --noconftest tests/test_torch_clustering.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 runs on the card")
    from torchmetrics_tpu_torch.ops import bincount

    preds, target = _labels("gapped_negative", n=20_000)
    card = torch.device("cuda", 0)
    before = bincount.BINCOUNT.launches
    cm = utils.calculate_contingency_matrix(torch.from_numpy(preds).to(card), torch.from_numpy(target).to(card))
    assert bincount.BINCOUNT.launches == before + 1
    np.testing.assert_array_equal(cm.cpu().numpy(),
                                  utils.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target)).numpy())
    for name in EXTRINSIC:
        got = getattr(pfc, name)(torch.from_numpy(preds).to(card), torch.from_numpy(target).to(card))
        _close(got.cpu(), getattr(pfc, name)(torch.from_numpy(preds), torch.from_numpy(target)))
    data, labels = _data(n=2000, k=20, d=32)
    for name in ("calinski_harabasz_score", "davies_bouldin_score", "dunn_index"):
        got = getattr(pfc, name)(torch.from_numpy(data).to(card), torch.from_numpy(labels).to(card))
        _close(got.cpu(), getattr(pfc, name)(torch.from_numpy(data), torch.from_numpy(labels)))
