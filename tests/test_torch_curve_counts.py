"""Kernel K3 of the PyTorch port (``ops/curve_counts.py``) against the JAX package.

On the CPU the port's entries run their plain versions. The JAX side runs ``curve_counts_pallas``
in interpret mode for one class, as ``tests/unittests/bases/test_pallas_ops.py`` does, its
class-batched ``_indicator_counts`` for several, and ``_binned_counts`` for the binned entry. Counts of 0/1 weights must be equal exactly;
sums of general float32 weights, added in another order, agree within rtol 1e-6 (plus atol 1e-6
for sums near zero). The JAX package is imported inside a fixture, so that the card test at the
end also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_curve_counts.py -m cuda
"""
from __future__ import annotations

import importlib
import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.ops import curve_counts as k3


@pytest.fixture(scope="module")
def jax_curve():
    jnp = pytest.importorskip("jax.numpy")
    from torchmetrics_tpu.functional.classification.precision_recall_curve import _indicator_counts
    from torchmetrics_tpu.ops.pallas_curve import curve_counts_pallas

    return jnp, curve_counts_pallas, _indicator_counts


@pytest.fixture(scope="module")
def jax_binned():
    jnp = pytest.importorskip("jax.numpy")
    from torchmetrics_tpu.ops.pallas_curve import curve_counts_pallas

    jax_prc = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")
    return jnp, jax_prc, curve_counts_pallas


def _inputs(num_classes: int, n: int, thresholds: np.ndarray, seed: int, weights: str = "binary"):
    """Scores in [0, 1] with some exactly on a threshold, and a NaN, +inf and -inf among them."""
    rng = np.random.RandomState(seed)
    scores = rng.rand(num_classes, n).astype(np.float32)
    if n >= 8:
        on = rng.randint(0, n, max(1, n // 10))
        scores[:, on] = thresholds[rng.randint(0, thresholds.size, on.size)]
        scores[0, 1], scores[0, 3], scores[-1, 5] = np.nan, np.inf, -np.inf
    if weights == "binary":
        pos = (rng.rand(num_classes, n) < 0.4).astype(np.float32)
        neg = (1.0 - pos) * (rng.rand(num_classes, n) < 0.9)
    else:
        pos = rng.rand(num_classes, n).astype(np.float32)
        neg = rng.rand(num_classes, n).astype(np.float32)
    return scores, pos, neg.astype(np.float32)


def _numpy_counts(scores, pos, neg, thresholds):
    hit = scores[:, :, None] >= thresholds[None, None, :]
    return (pos[:, :, None] * hit).sum(1, dtype=np.float64), (neg[:, :, None] * hit).sum(1, dtype=np.float64)


def _port(scores, pos, neg, thresholds):
    tp, fp = k3.curve_counts(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (scores, pos, neg, thresholds)))
    assert tp.dtype == torch.float32 and tp.shape == (scores.shape[0], thresholds.size)
    return tp.numpy(), fp.numpy()


GRIDS = {
    "T=1": np.linspace(0.0, 1.0, 1, dtype=np.float32),
    "T=2": np.linspace(0.0, 1.0, 2, dtype=np.float32),
    "T=200": np.linspace(0.0, 1.0, 200, dtype=np.float32),
    "T=2048": np.linspace(0.0, 1.0, 2048, dtype=np.float32),
    "unsorted": np.random.RandomState(3).rand(37).astype(np.float32),
}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("n", [0, 1, 777, 4097])
def test_one_class_matches_pallas(jax_curve, grid, n):
    jnp, curve_counts_pallas, _ = jax_curve
    thresholds = GRIDS[grid]
    if grid == "T=2048" and n == 4097:
        n = 1500  # the interpret-mode kernel forms a (4096, 128) compare per threshold row
    scores, pos, neg = _inputs(1, n, thresholds, seed=n)
    tp, fp = _port(scores, pos, neg, thresholds)
    jtp, jfp = curve_counts_pallas(jnp.asarray(scores[0]), jnp.asarray(pos[0]), jnp.asarray(neg[0]), jnp.asarray(thresholds))
    np.testing.assert_array_equal(tp[0], np.asarray(jtp))
    np.testing.assert_array_equal(fp[0], np.asarray(jfp))
    want_tp, want_fp = _numpy_counts(scores, pos, neg, thresholds)
    np.testing.assert_array_equal(tp, want_tp)
    np.testing.assert_array_equal(fp, want_fp)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("num_classes,n", [(2, 0), (3, 1), (5, 2000), (7, 4097)])
def test_classes_match_indicator_counts(jax_curve, grid, num_classes, n):
    jnp, _, indicator_counts = jax_curve
    thresholds = GRIDS[grid]
    scores, pos, neg = _inputs(num_classes, n, thresholds, seed=num_classes * 1000 + n)
    tp, fp = _port(scores, pos, neg, thresholds)
    jtp, jfp = indicator_counts(jnp.asarray(scores), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(thresholds))
    np.testing.assert_array_equal(tp, np.asarray(jtp))
    np.testing.assert_array_equal(fp, np.asarray(jfp))


@pytest.mark.parametrize("num_classes,n", [(1, 1000), (4, 2500)])
def test_general_weights_match_within_rtol(jax_curve, num_classes, n):
    jnp, curve_counts_pallas, indicator_counts = jax_curve
    thresholds = GRIDS["T=200"]
    scores, pos, neg = _inputs(num_classes, n, thresholds, seed=7, weights="general")
    tp, fp = _port(scores, pos, neg, thresholds)
    jtp, jfp = indicator_counts(jnp.asarray(scores), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(thresholds))
    np.testing.assert_allclose(tp, np.asarray(jtp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fp, np.asarray(jfp), rtol=1e-6, atol=1e-6)
    if num_classes == 1:
        ptp, pfp = curve_counts_pallas(jnp.asarray(scores[0]), jnp.asarray(pos[0]), jnp.asarray(neg[0]), jnp.asarray(thresholds))
        np.testing.assert_allclose(tp[0], np.asarray(ptp), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(fp[0], np.asarray(pfp), rtol=1e-6, atol=1e-6)


def test_plain_version_chunks_samples(monkeypatch):
    # a chunk smaller than N gives the same counts: memory stays O(C * chunk * T)
    thresholds = GRIDS["T=200"]
    scores, pos, neg = _inputs(3, 1001, thresholds, seed=2)
    whole = _port(scores, pos, neg, thresholds)
    monkeypatch.setattr(k3, "PLAIN_CHUNK_ELEMENTS", 3 * 200 * 7)
    chunked = _port(scores, pos, neg, thresholds)
    np.testing.assert_array_equal(whole[0], chunked[0])
    np.testing.assert_array_equal(whole[1], chunked[1])


@pytest.mark.parametrize("n,num_classes,num_thr", [
    (0, 1, 1), (1, 1, 1), (10_000, 1, 200), (1_000_000, 1, 200), (200_000, 5, 200), (4097, 1000, 2048),
    (1_000_003, 5, 2048), (50, 3, 5000), (10, 70_000, 1),
])
def test_launch_plan_covers_the_work(n, num_classes, num_thr):
    plan = k3.launch_plan(n, num_classes, num_thr, sms=132)
    assert plan.per_thread in (1, 2, 4, 8)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.threads * plan.per_thread * plan.chunks_t >= num_thr  # every threshold has a thread
    assert (plan.chunks_t - 1) * plan.threads * plan.per_thread < num_thr  # and no chunk is empty
    assert plan.blocks * plan.chunk >= n and (plan.blocks - 1) * plan.chunk < max(n, 1)  # no empty sample chunk
    assert plan.blocks <= max(1, -(-n // k3.TILE))


BINNED_GRIDS = {
    "T=2": np.linspace(0.0, 1.0, 2, dtype=np.float32),
    "T=200": np.linspace(0.0, 1.0, 200, dtype=np.float32),
    "T=2048": np.linspace(0.0, 1.0, 2048, dtype=np.float32),
    # repeated thresholds, -0.0 beside 0.0, and +-inf: the bucketize must meet what the compare meets
    "dup": np.sort(np.r_[np.float32(-np.inf), np.float32(-0.0), np.linspace(0, 1, 9), np.linspace(0, 1, 5),
                         0.5, 0.5, np.float32(np.inf)].astype(np.float32)),
}


def binned_inputs(kind: str, n: int, num_classes: int, thresholds: np.ndarray, seed: int, ignore_index=None):
    """``(N, C)`` scores (``(N,)`` for binary) with some on a threshold, a NaN, +inf, -inf, +-0,
    and a target with ``ignore_index`` on about 10% of its entries."""
    rng = np.random.RandomState(seed)
    cols = 1 if kind == "binary" else num_classes
    scores = rng.rand(n, cols).astype(np.float32)
    if n >= 8:
        on = rng.randint(0, n, max(1, n // 10))
        finite = thresholds[np.isfinite(thresholds)]
        scores[on] = finite[rng.randint(0, finite.size, (on.size, cols))]
        scores[1, 0], scores[3, -1], scores[5, 0], scores[6, -1], scores[7, 0] = np.nan, np.inf, -np.inf, -0.0, 0.0
    if kind == "multiclass":
        target = rng.randint(0, num_classes, n)
    else:
        target = rng.randint(0, 2, (n, cols))
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.1] = ignore_index
    if kind == "binary":
        scores, target = scores[:, 0], target[:, 0]
    return scores, target.astype(np.int32)


def _binned_port(kind, scores, target, thresholds, num_classes, ignore_index):
    out = k3.binned_confmat(torch.from_numpy(np.ascontiguousarray(scores)), torch.from_numpy(target),
                            torch.from_numpy(thresholds), kind, num_classes, ignore_index)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("grid", list(BINNED_GRIDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("n", [0, 1, 1500])
def test_binned_binary_matches_binned_counts(jax_binned, grid, ignore_index, n):
    jnp, jax_prc, curve_counts_pallas = jax_binned
    thresholds = BINNED_GRIDS[grid]
    scores, target = binned_inputs("binary", n, 1, thresholds, seed=n + 3, ignore_index=ignore_index)
    ours = _binned_port("binary", scores, target, thresholds, 1, ignore_index)
    assert ours.shape == (thresholds.size, 2, 2)
    weight = (target != ignore_index).astype(np.float32) if ignore_index is not None else np.ones(n, np.float32)
    target01 = np.where(weight > 0, target, 0)
    tp, fp, tn, fn = jax_prc._binned_counts(jnp.asarray(scores), jnp.asarray(target01), jnp.asarray(weight),
                                            jnp.asarray(thresholds))
    for got, want in ((ours[:, 1, 1], tp), (ours[:, 0, 1], fp), (ours[:, 0, 0], tn), (ours[:, 1, 0], fn)):
        np.testing.assert_array_equal(got, np.asarray(want))
    if grid != "T=2048":  # the interpret-mode kernel forms a (4096, 128) compare per threshold row
        pos, neg = target01 * weight, (1 - target01) * weight
        ptp, pfp = curve_counts_pallas(jnp.asarray(scores), jnp.asarray(pos.astype(np.float32)),
                                       jnp.asarray(neg.astype(np.float32)), jnp.asarray(thresholds))
        np.testing.assert_array_equal(ours[:, 1, 1], np.asarray(ptp))
        np.testing.assert_array_equal(ours[:, 0, 1], np.asarray(pfp))


@pytest.mark.parametrize("grid", list(BINNED_GRIDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("kind", ["multiclass", "multilabel"])
def test_binned_classes_match_indicator_counts(jax_binned, grid, ignore_index, kind):
    jnp, jax_prc, _ = jax_binned
    thresholds, num_classes, n = BINNED_GRIDS[grid], 5, 1200
    scores, target = binned_inputs(kind, n, num_classes, thresholds, seed=len(grid), ignore_index=ignore_index)
    ours = _binned_port(kind, scores, target, thresholds, num_classes, ignore_index)
    assert ours.shape == (thresholds.size, num_classes, 2, 2)
    kept = target != ignore_index if ignore_index is not None else np.ones(target.shape, bool)
    if kind == "multiclass":
        pos = (target[:, None] == np.arange(num_classes)[None, :]) & kept[:, None]
        neg = (target[:, None] != np.arange(num_classes)[None, :]) & kept[:, None]
    else:
        pos, neg = (target == 1) & kept, (target == 0) & kept
    pos_cn, neg_cn = pos.T.astype(np.float32), neg.T.astype(np.float32)
    tp, fp = jax_prc._indicator_counts(jnp.asarray(scores.T), jnp.asarray(pos_cn), jnp.asarray(neg_cn),
                                       jnp.asarray(thresholds))
    np.testing.assert_array_equal(ours[:, :, 1, 1], np.asarray(tp).T)
    np.testing.assert_array_equal(ours[:, :, 0, 1], np.asarray(fp).T)
    np.testing.assert_array_equal(ours[:, :, 1, 0], pos_cn.sum(1)[None, :] - np.asarray(tp).T)
    np.testing.assert_array_equal(ours[:, :, 0, 0], neg_cn.sum(1)[None, :] - np.asarray(fp).T)


@pytest.mark.parametrize("n,num_classes,num_thr", [
    (0, 1, 1), (1, 1, 1), (10_000, 1, 200), (1_000_000, 1, 200), (200_000, 5, 200), (4097, 1000, 2048),
    (1_000_003, 5, 2048), (50, 3, 5000), (10, 70_000, 1), (7, 3, 4000), (7, 3, 4100),
])
def test_binned_plan_covers_the_work(n, num_classes, num_thr):
    plan = k3.binned_plan(n, num_classes, num_thr, sms=132)
    assert plan.groups * plan.group >= num_classes and (plan.groups - 1) * plan.group < num_classes
    assert 1 <= plan.groups <= 65535 and plan.head >= plan.groups and plan.head % 32 == 0
    assert 1 <= plan.blocks <= max(1, -(-n // k3.BINNED_THREADS))
    words = 2 * (num_thr + 1)
    if plan.shared_bytes:  # the thresholds and the group's histograms, within the default limit
        assert plan.shared_bytes == 4 * (num_thr + plan.group * words) <= k3.BINNED_SHARED_BYTES
    else:  # not one class fits: every class counts in the global scratch, in one group
        assert 4 * (num_thr + words) > k3.BINNED_SHARED_BYTES and plan.group == num_classes


def test_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4))
    with pytest.raises(TypeError, match="float32"):
        k3.curve_counts(x.double(), x, x, torch.zeros(2))
    with pytest.raises(ValueError, match=r"\(C, N\)"):
        k3.curve_counts(x[0], x[0], x[0], torch.zeros(2))
    with pytest.raises(ValueError, match="must match"):
        k3.curve_counts(x, x[:, :3], x, torch.zeros(2))
    with pytest.raises(ValueError, match="non-empty"):
        k3.curve_counts(x, x, x, torch.zeros(0))


def test_binned_rejects_what_the_kernel_does_not_take():
    s, t, thr = torch.zeros(4), torch.zeros(4, dtype=torch.int32), torch.zeros(2)
    with pytest.raises(ValueError, match="kind"):
        k3.binned_confmat(s, t, thr, "ranking")
    with pytest.raises(TypeError, match="float32"):
        k3.binned_confmat(s.double(), t, thr, "binary")
    with pytest.raises(TypeError, match="target"):
        k3.binned_confmat(s, t.float(), thr, "binary")
    with pytest.raises(ValueError, match="shapes"):
        k3.binned_confmat(s, t, thr, "multiclass", 3)
    with pytest.raises(ValueError, match="non-empty"):
        k3.binned_confmat(s, t, thr[:0], "binary")


def test_cpu_tensors_take_the_plain_version():
    before = k3.BINNED_CONFMAT.launches
    out = k3.binned_confmat(torch.tensor([0.2, 0.7, 0.5]), torch.tensor([1, 1, 0]), torch.tensor([0.0, 0.5, 1.0]), "binary")
    np.testing.assert_array_equal(out[:, 1, 1].numpy(), [2.0, 1.0, 0.0])
    np.testing.assert_array_equal(out[:, 0, 1].numpy(), [1.0, 1.0, 0.0])
    assert k3.BINNED_CONFMAT.launches == before
    before = k3.CURVE_COUNTS.launches
    tp, fp = k3.curve_counts(torch.tensor([[0.2, 0.7, 0.5]]), torch.tensor([[1.0, 1.0, 0.0]]),
                             torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([0.0, 0.5, 1.0]))
    np.testing.assert_array_equal(tp.numpy(), [[2.0, 1.0, 0.0]])
    np.testing.assert_array_equal(fp.numpy(), [[1.0, 1.0, 0.0]])
    assert k3.CURVE_COUNTS.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda_device):
    before = k3.CURVE_COUNTS.launches
    launched = 0
    for num_classes, n, grid in ((1, 0, "T=200"), (1, 1, "T=1"), (1, 100_003, "T=200"), (5, 40_000, "T=2048"),
                                 (300, 4097, "unsorted"), (2, 3000, "T=2")):
        thresholds = GRIDS[grid]
        for weights in ("binary", "general"):
            scores, pos, neg = _inputs(num_classes, n, thresholds, seed=n, weights=weights)
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in (scores, pos, neg, thresholds)]
            tp, fp = k3.curve_counts(*args)
            again = k3.curve_counts(*args)
            ptp, pfp = k3.curve_counts_plain(*args)
            launched += 2 * (n > 0)
            assert torch.equal(tp, again[0]) and torch.equal(fp, again[1])  # fixed order: bitwise repeatable
            if weights == "binary":
                assert torch.equal(tp, ptp) and torch.equal(fp, pfp)
            else:
                torch.testing.assert_close(tp, ptp, rtol=1e-5, atol=1e-5)
                torch.testing.assert_close(fp, pfp, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert k3.CURVE_COUNTS.launches == before + launched


def k3_card_cases(device: torch.device):
    """The direct body's K3 cases on 0/1 inputs (``chip_smoke.py``): ``(name, kind, C, scores (N, C), target,
    thresholds)`` over C = 1, 5 and 1000, N = 0 to 1,000,003 and T = 1, 200 and 2048, with scores on
    thresholds, NaN and +-inf, and ``ignore_index=-1`` on some targets."""
    gen = np.random.RandomState(3)
    for num_classes in (1, 5, 1000):
        for n in (0, 1, 4097, 1_000_003):
            if num_classes * n > 6_000_000:
                continue
            for num_thr in (1, 200, 2048):
                thr = np.linspace(0.0, 1.0, num_thr, dtype=np.float32)
                scores = gen.rand(n, num_classes).astype(np.float32)
                if n >= 8:
                    on = gen.randint(0, n, n // 10 + 1)
                    scores[on, :] = thr[gen.randint(0, num_thr, on.size)][:, None]
                    scores[1, 0], scores[3, 0], scores[5, -1] = np.nan, np.inf, -np.inf
                kinds = ("binary", "multilabel") if num_classes == 1 else ("multiclass", "multilabel")
                for kind in kinds:
                    if kind == "multiclass":
                        target = gen.randint(-1, num_classes, n)
                    else:
                        target = gen.randint(-1, 2, (n, num_classes))
                    s = scores[:, 0] if kind == "binary" else scores
                    t = target[:, 0] if kind == "binary" else target
                    yield (f"C={num_classes} N={n} T={num_thr} {kind}", kind, num_classes,
                           *(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (s, t.astype(np.int32), thr)))


def direct_weights(kind: str, num_classes: int, target: torch.Tensor, ignore_index: int = -1):
    """The direct body's ``(C, N)`` 0/1 pos and neg weights of a binned entry's target."""
    t = (target[:, None] if target.ndim == 1 else target).to(torch.int64)
    kept = t != ignore_index
    if kind == "multiclass":
        classes = torch.arange(num_classes, device=t.device)[None, :]
        pos, neg = (t == classes) & kept, (t != classes) & kept
    else:
        pos, neg = (t == 1) & kept, (t == 0) & kept
    return pos.T.float().contiguous(), neg.T.float().contiguous()


@pytest.mark.cuda
def test_binned_equals_the_direct_body_on_cuda(cuda_device):
    before = k3.BINNED_CONFMAT.launches
    launched = cases = 0
    for name, kind, num_classes, scores, target, thr in k3_card_cases(cuda_device):
        out = k3.binned_confmat(scores, target, thr, kind, num_classes, ignore_index=-1)
        again = k3.binned_confmat(scores, target, thr, kind, num_classes, ignore_index=-1)
        launched += 2 * (scores.shape[0] > 0)
        pos, neg = direct_weights(kind, num_classes, target)
        rows = (scores[:, None] if scores.ndim == 1 else scores).T.contiguous()
        tp, fp = k3.curve_counts(rows, pos, neg, thr)
        cm = out.reshape(thr.numel(), -1, 2, 2)
        assert torch.equal(out, again), name  # the ticket and the sums were left clean
        assert torch.equal(cm[:, :, 1, 1], tp.T) and torch.equal(cm[:, :, 0, 1], fp.T), name
        assert torch.equal(cm[:, :, 1, 0], pos.sum(1)[None, :] - tp.T), name
        assert torch.equal(cm[:, :, 0, 0], neg.sum(1)[None, :] - fp.T), name
        assert torch.equal(out, k3.binned_confmat_plain(scores, target, thr, kind, num_classes, -1)), name
        cases += 1
    torch.cuda.synchronize()
    assert k3.BINNED_CONFMAT.launches == before + launched and cases == 66


@pytest.mark.cuda
def test_binned_global_histograms_on_cuda(cuda_device):
    # T > 4000: not one class's histograms fit in 47 KB, so they count in the global scratch
    rng = np.random.RandomState(8)
    thr = torch.from_numpy(np.linspace(0, 1, 5000, dtype=np.float32)).to(cuda_device)
    scores = torch.from_numpy(rng.rand(300_000, 3).astype(np.float32)).to(cuda_device)
    target = torch.from_numpy(rng.randint(-1, 3, 300_000)).to(cuda_device)
    assert k3.binned_plan(300_000, 3, 5000, 132).shared_bytes == 0
    for _ in range(2):
        got = k3.binned_confmat(scores, target, thr, "multiclass", 3, ignore_index=-1)
        assert torch.equal(got, k3.binned_confmat_plain(scores, target, thr, "multiclass", 3, -1))
