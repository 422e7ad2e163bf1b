"""The port's nominal association (``functional/nominal``, ``nominal/``) against the JAX package.

The same seeded numpy inputs go through the JAX package and through the port on the CPU, where K1
takes its plain version: confusion counts exactly, values within 1e-5 relative. Covered: both NaN
strategies, a ``nan_replace_value`` outside ``[0, C)`` (dropped, as the JAX package's one-hot drops
it), 2-D inputs (argmax), gapped category values, ``bias_correction`` on and off, a ``df == 1``
table (the Yates correction) and a table where bias correction cannot be used (the warning and
NaN), the four ``_matrix`` forms, Fleiss' kappa in both modes, and every validator. The drop mask
reaches K1 as a bool tensor with no read of the device, and the four association classes' fused
forward runs on the emulated graph tier bit-equal to the eager tier. JAX is imported inside
fixtures, so that the card test runs where there is no JAX.
The JAX side runs op by op (``tests/torch_jax_pool.jax_op_by_op``): each case is a configuration of its own,
which a jitted call would compile whole.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torchmetrics_tpu_torch as port
import torchmetrics_tpu_torch.functional.nominal as pfn
from torchmetrics_tpu_torch.functional.nominal import utils as nominal_utils
from torchmetrics_tpu_torch.ops import dispatch, histogram
from torchmetrics_tpu_torch.utils import checks
from torch_jax_pool import jax_op_by_op  # noqa: F401  (autouse: the JAX side op by op)
#: a case that keeps JAX's jit on (``jax_op_by_op``), so the port is held to JAX's traced branches too
JAX_JITTED_CASES = ('test_pair_functional[cramers_v-replace-nan]',)

TOL = 1e-5
PAIR_FUNCTIONS = ["cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u"]
CONFMAT_CLASSES = {"cramers_v": "CramersV", "tschuprows_t": "TschuprowsT",
                   "pearsons_contingency_coefficient": "PearsonsContingencyCoefficient", "theils_u": "TheilsU"}
BIAS = ("cramers_v", "tschuprows_t")


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    import torchmetrics_tpu.functional.nominal as jfn
    from torchmetrics_tpu.functional.nominal import utils as jutils

    return SimpleNamespace(top=jt, fn=jfn, utils=jutils)


def _close(ours, theirs, rtol=TOL):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64), rtol=rtol, atol=rtol,
                               equal_nan=True)


def _codes(case: str, n: int = 500, seed: int = 0, classes: int = 5):
    """A pair of categorical series as float32 codes (NaN marks a missing value)."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, classes, n).astype(np.float32)
    preds = np.where(rng.rand(n) < 0.5, target, rng.randint(0, classes, n)).astype(np.float32)
    if case == "nan":
        preds[rng.rand(n) < 0.08] = np.nan
        target[rng.rand(n) < 0.08] = np.nan
    elif case == "gapped":
        preds, target = preds * 4 - 3, target * 4 - 3
    elif case == "two_by_two":  # df == 1: the Yates correction
        preds, target = (preds > 2).astype(np.float32), (target > 1).astype(np.float32)
    elif case == "one_row":  # a single target category: bias correction cannot be used
        target = np.full(n, 2.0, np.float32)
    elif case == "probs":
        onehot = lambda x: (np.eye(classes)[x.astype(int)] + rng.rand(n, classes) * 0.5).astype(np.float32)  # noqa: E731
        return onehot(preds), onehot(target)
    return preds, target


def _kw(name, nan_strategy="replace", nan_replace_value=0.0, bias_correction=True):
    kw = {"nan_strategy": nan_strategy, "nan_replace_value": nan_replace_value}
    if name in BIAS:
        kw["bias_correction"] = bias_correction
    return kw


# ------------------------------------------------------------------ the functionals
@pytest.mark.parametrize("case", ["plain", "nan", "gapped", "two_by_two", "probs"])
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("name", PAIR_FUNCTIONS)
def test_pair_functional(jax, name, nan_strategy, case):
    preds, target = _codes(case, seed=len(name))
    kw = _kw(name, nan_strategy)
    ours = getattr(pfn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    assert ours.dtype == torch.float32 and ours.shape == ()
    _close(ours, getattr(jax.fn, name)(preds, target, **kw))


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("case", ["plain", "two_by_two", "nan"])
@pytest.mark.parametrize("name", BIAS)
def test_bias_correction(jax, name, case, bias_correction):
    preds, target = _codes(case, seed=3)
    kw = _kw(name, bias_correction=bias_correction)
    _close(getattr(pfn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw),
           getattr(jax.fn, name)(preds, target, **kw))


@pytest.mark.parametrize("name", BIAS)
def test_bias_correction_unusable_warns_and_gives_nan(jax, name):
    preds, target = _codes("one_row")
    with pytest.warns(UserWarning, match="Unable to compute"):
        ours = getattr(pfn, name)(torch.from_numpy(preds), torch.from_numpy(target))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = getattr(jax.fn, name)(preds, target)
    assert np.isnan(float(ours)) and np.isnan(float(theirs))


@pytest.mark.parametrize("nan_replace_value", [0.0, 3, -1.0, 11.0])
@pytest.mark.parametrize("name", PAIR_FUNCTIONS)
def test_nan_replace_value(jax, name, nan_replace_value):
    preds, target = _codes("nan", seed=7)
    kw = _kw(name, "replace", nan_replace_value)
    _close(getattr(pfn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw),
           getattr(jax.fn, name)(preds, target, **kw))


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("name", PAIR_FUNCTIONS)
def test_matrix_functional(jax, name, nan_strategy):
    rng = np.random.RandomState(11)
    matrix = np.stack([rng.randint(0, k, 300) for k in (3, 5, 2, 7)], axis=1).astype(np.float32)
    matrix[:, 2] = np.where(rng.rand(300) < 0.7, matrix[:, 0] > 1, matrix[:, 2])
    matrix[rng.rand(300, 4) < 0.03] = np.nan
    kw = _kw(name, nan_strategy)
    ours = getattr(pfn, name + "_matrix")(torch.from_numpy(matrix), **kw)
    assert ours.shape == (4, 4) and ours.dtype == torch.float32
    _close(ours, getattr(jax.fn, name + "_matrix")(matrix, **kw))


DEGENERATE = {
    "one_effective_row": (np.array([0, 0, 0, 0], np.float32), np.array([0, 1, 0, 1], np.float32)),
    "both_constant": (np.array([2, 2, 2], np.float32), np.array([1, 1, 1], np.float32)),
    "all_pairs_dropped": (np.full(4, np.nan, np.float32), np.array([0, 1, 0, 1], np.float32)),
}


@pytest.mark.parametrize("case", sorted(DEGENERATE))
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("name", PAIR_FUNCTIONS)
def test_degenerate_tables_give_jax_s_nan(jax, name, bias_correction, case):
    """NaN where JAX and the reference give NaN (queue C, C3): the JAX package's ``jnp.maximum(x, 1e-38)``
    guards divide 0/0 once XLA flushes the subnormal, where a kept 1e-38 would give 0. The functional,
    the ``_matrix`` form and the class agree with JAX's."""
    preds, target = DEGENERATE[case]
    kw = {"nan_strategy": "drop"}
    if name in BIAS:
        kw["bias_correction"] = bias_correction
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jax.fn, name)(preds, target, **kw)
        _close(getattr(pfn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw), want)
        if case != "all_pairs_dropped":
            matrix = np.stack([preds, target, target], axis=1)
            _close(getattr(pfn, name + "_matrix")(torch.from_numpy(matrix), **kw),
                   getattr(jax.fn, name + "_matrix")(matrix, **kw))
        ours = getattr(port, CONFMAT_CLASSES[name])(num_classes=3, device="cpu", **kw)
        theirs = getattr(jax.top, CONFMAT_CLASSES[name])(num_classes=3, **kw)
        ours.update(torch.from_numpy(preds), torch.from_numpy(target))
        theirs.update(preds, target)
        _close(ours.compute(), theirs.compute())
    if name != "theils_u" and (case == "all_pairs_dropped" or (name in BIAS and not bias_correction)):
        assert np.isnan(float(want))


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa(jax, mode):
    rng = np.random.RandomState(13)
    ratings = rng.rand(200, 6, 4).astype(np.float32) if mode == "probs" else rng.multinomial(5, [0.3, 0.2, 0.4, 0.1], 200)
    _close(pfn.fleiss_kappa(torch.from_numpy(ratings), mode), jax.fn.fleiss_kappa(ratings, mode))


def test_fleiss_probs_counts_exact(jax):
    """The per-subject counts of ``probs`` mode (K1's ``row * C + argmax``) equal JAX's one-hot sums."""
    from torchmetrics_tpu.functional.nominal.fleiss_kappa import _fleiss_kappa_update as jax_update

    from torchmetrics_tpu_torch.functional.nominal.fleiss_kappa import _fleiss_kappa_update

    ratings = np.random.RandomState(17).rand(300, 10, 5).astype(np.float32)
    ours = _fleiss_kappa_update(torch.from_numpy(ratings), "probs")
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_update(ratings, "probs")))


# ------------------------------------------------------------------ the validators
@pytest.mark.parametrize("kwargs", [{"nan_strategy": "mean"}, {"nan_strategy": "replace", "nan_replace_value": None},
                                    {"nan_strategy": "replace", "nan_replace_value": "0"}])
def test_nominal_validation_as_jax(jax, kwargs):
    preds, target = _codes("plain", n=20)
    for name in PAIR_FUNCTIONS:
        with pytest.raises(ValueError) as theirs:
            getattr(jax.fn, name)(preds, target, **kwargs)
        with pytest.raises(ValueError) as ours:
            getattr(pfn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        assert str(ours.value) == str(theirs.value)
        with pytest.raises(ValueError) as ours:
            getattr(port, CONFMAT_CLASSES[name])(num_classes=3, device="cpu", **kwargs)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("ratings, mode", [(np.ones((4, 3), np.float32), "counts"), (np.ones((4, 3, 2), np.int64), "counts"),
                                           (np.ones((4, 3), np.float32), "probs"), (np.ones((4, 3, 2), np.int64), "probs"),
                                           (np.ones((4, 3), np.int64), "votes")])
def test_fleiss_validation_as_jax(jax, ratings, mode):
    with pytest.raises(ValueError) as theirs:
        jax.fn.fleiss_kappa(ratings, mode)
    with pytest.raises(ValueError) as ours:
        pfn.fleiss_kappa(torch.from_numpy(ratings), mode)
    assert str(ours.value) == str(theirs.value)


def test_class_arguments_as_jax(jax):
    for name, kwargs in (("CramersV", {"num_classes": 0}), ("TheilsU", {"num_classes": 2.0}), ("FleissKappa", {"mode": "x"})):
        with pytest.raises(ValueError) as theirs:
            getattr(jax.top, name)(**kwargs)
        with pytest.raises(ValueError) as ours:
            getattr(port, name)(device="cpu", **kwargs)
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ the classes
CLASS_CASES = [
    ("CramersV", {}), ("CramersV", {"bias_correction": False, "nan_strategy": "drop"}),
    ("TschuprowsT", {"nan_strategy": "drop"}), ("TschuprowsT", {"bias_correction": False}),
    ("PearsonsContingencyCoefficient", {}), ("PearsonsContingencyCoefficient", {"nan_strategy": "drop"}),
    ("TheilsU", {}), ("TheilsU", {"nan_strategy": "drop"}),
    ("CramersV", {"nan_replace_value": -1.0}), ("TheilsU", {"nan_replace_value": 9}),
]


@pytest.mark.parametrize("name,kwargs", CLASS_CASES, ids=[f"{c}-{i}" for i, (c, _) in enumerate(CLASS_CASES)])
def test_confmat_class_against_jax(jax, name, kwargs):
    """``forward`` four batches with NaN (each batch value against JAX's), a 2-D batch, then
    ``compute`` and the summed confusion matrix, equal to JAX's exactly; a replace value outside
    ``[0, C)`` drops the pair in both."""
    ours, theirs = getattr(port, name)(num_classes=6, device="cpu", **kwargs), getattr(jax.top, name)(num_classes=6, **kwargs)
    for seed in range(4):
        preds, target = _codes("nan", n=150, seed=seed, classes=6)
        _close(ours(torch.from_numpy(preds), torch.from_numpy(target)), theirs(preds, target))
    preds, target = _codes("probs", n=150, seed=9, classes=6)
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    theirs.update(preds, target)
    np.testing.assert_array_equal(ours.metric_state["confmat"].numpy(), np.asarray(theirs.metric_state["confmat"]))
    assert ours.metric_state["confmat"].dtype == torch.float32
    _close(ours.compute(), theirs.compute())


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_class_against_jax(jax, mode):
    rng = np.random.RandomState(19)
    ours, theirs = port.FleissKappa(mode=mode, device="cpu"), jax.top.FleissKappa(mode=mode)
    for _ in range(3):
        ratings = rng.rand(50, 5, 3).astype(np.float32) if mode == "probs" else rng.multinomial(3, [0.5, 0.2, 0.3], 50)
        _close(ours(torch.from_numpy(ratings)), theirs(ratings))
    _close(ours.compute(), theirs.compute())


# ------------------------------------------------------------------ no read of the device on the update
UNCAPTURABLE = ("_local_scalar_dense", "nonzero", "lift_fresh", "masked_select", "unique")


class _NoHostSync(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(bad in func.__name__ for bad in UNCAPTURABLE):
            raise AssertionError(f"{func.__name__} cannot be captured in a CUDA graph")
        return func(*args, **(kwargs or {}))


def test_drop_mask_reaches_k1_as_bool_with_no_host_read(monkeypatch):
    """``"drop"`` passes the mask as bool: ``ops/histogram.confusion_matrix_update`` sends it to K1's
    masked confusion count without reading it (its float-weight branch, which reads the device to
    tell 0/1 weights from others, is never taken), and the counts equal numpy's."""
    seen = {}

    def weighted(*args, **kwargs):
        raise AssertionError("the float-weight branch was taken")

    def counts(preds, target, num_classes, mask, ignore_index, dtype=torch.int32):
        seen["mask"] = mask
        return plain(preds, target, num_classes, mask, ignore_index, dtype)

    from torchmetrics_tpu_torch.ops import bincount

    plain = bincount.confusion_counts_plain
    monkeypatch.setattr(histogram, "_weighted_confusion", weighted)
    monkeypatch.setattr(histogram._k1, "confusion_counts", counts)
    preds, target = _codes("nan", n=400, seed=23, classes=6)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    with _NoHostSync():
        got = nominal_utils._nominal_confmat_update(p, t, 6, "drop")
    assert seen["mask"].dtype == torch.bool
    keep = ~(np.isnan(preds) | np.isnan(target))
    want = np.bincount(target[keep].astype(int) * 6 + preds[keep].astype(int), minlength=36).reshape(6, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(set(CONFMAT_CLASSES.values())))
def test_fused_forward_makes_no_host_read(monkeypatch, name):
    """Update on the defaults, compute and merge of each association class under the mode that
    raises on a host read, as under capture (the bias-correction warning is skipped there)."""
    from torchmetrics_tpu_torch.metric import _merge_tensor_ladder

    monkeypatch.setattr(checks, "capturing", lambda x: True)
    m = getattr(port, name)(num_classes=6, nan_strategy="drop", device="cpu")
    preds, target = (torch.from_numpy(a) for a in _codes("nan", n=200, classes=6))
    defaults = m._default_state()
    with _NoHostSync():
        out = m._update(dict(defaults), preds, target)
        m._compute({k: out.get(k, v) for k, v in defaults.items()})
        _merge_tensor_ladder(dict(m._tensors), out, m._defaults, m._reductions, torch.ones(()))


def test_confmat_classes_on_the_emulated_graph_tier(monkeypatch):
    """The four classes' ``forward`` is one captured step on the graph tier (emulated here), bit-equal
    to the eager tier, with no fallback; ``FleissKappa``'s list state keeps it eager."""
    results = {}
    for tier in ("graph", "eager"):
        monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
        if tier == "eager":
            monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
        dispatch.STATS.reset()
        metrics = [getattr(port, c)(num_classes=6, nan_strategy=s, device="cpu")
                   for c in sorted(set(CONFMAT_CLASSES.values())) for s in ("replace", "drop")]
        values = []
        for seed in range(4):
            preds, target = (torch.from_numpy(a) for a in _codes("nan", n=200, seed=seed, classes=6))
            values += [m(preds, target) for m in metrics]
        values += [m.compute() for m in metrics]
        results[tier] = [v.numpy().tobytes() for v in values]
        if tier == "graph":
            assert dispatch.STATS.captures == len(metrics) and dispatch.STATS.n_fallbacks == 0
    assert results["graph"] == results["eager"]


@pytest.mark.cuda
def test_on_the_card():
    """On the card: each functional and class equals the CPU run within 1e-5, the confusion counts
    exactly, through K1 (launches counted). Run there with
    ``python -m pytest --noconftest tests/test_torch_nominal.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 runs on the card")
    from torchmetrics_tpu_torch.ops import bincount

    card = torch.device("cuda", 0)
    preds, target = _codes("nan", n=20_000, classes=40)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    before = bincount.BINCOUNT.launches
    got = nominal_utils._nominal_confmat_update(p.to(card), t.to(card), 40, "drop")
    assert bincount.BINCOUNT.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), nominal_utils._nominal_confmat_update(p, t, 40, "drop").numpy())
    for name in PAIR_FUNCTIONS:
        for strategy in ("replace", "drop"):
            _close(getattr(pfn, name)(p.to(card), t.to(card), nan_strategy=strategy).cpu(),
                   getattr(pfn, name)(p, t, nan_strategy=strategy))
    for name in sorted(set(CONFMAT_CLASSES.values())):
        on_card, on_cpu = getattr(port, name)(num_classes=40), getattr(port, name)(num_classes=40, device="cpu")
        for i in range(4):
            sl = slice(i * 5000, (i + 1) * 5000)
            _close(on_card(p[sl].to(card), t[sl].to(card)).cpu(), on_cpu(p[sl], t[sl]))
        _close(on_card.compute().cpu(), on_cpu.compute())
