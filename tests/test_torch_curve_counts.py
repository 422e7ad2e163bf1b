"""Kernel K3 of the PyTorch port (``ops/curve_counts.py``) against the JAX package.

On the CPU the port's entry runs its plain version. The JAX side runs ``curve_counts_pallas`` in
interpret mode for one class, as ``tests/unittests/bases/test_pallas_ops.py`` does, and its
class-batched ``_indicator_counts`` for several. Counts of 0/1 weights must be equal exactly;
sums of general float32 weights, added in another order, agree within rtol 1e-6 (plus atol 1e-6
for sums near zero). The JAX package is imported inside a fixture, so that the card test at the
end also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_curve_counts.py -m cuda
"""
from __future__ import annotations

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


def test_cpu_tensors_take_the_plain_version():
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
