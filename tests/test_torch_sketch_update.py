"""K2's fused sketch update (``ops/hist_pair.py::sketch_update``) against the JAX package.

On the CPU, ``sketch_update`` runs its plain version, the unfused chain of the curve classes'
sketch branch. Each case feeds the same numpy scores and targets to it and to the JAX package's
``hist_update_pair`` / ``hist_update_classes``, whose weights come from the JAX package's own
``_format`` functions and whose counts run through ``hist_pair_pallas`` in interpret mode (the
``"pallas"`` backend, as ``tests/unittests/sketch/test_countmin_hist.py`` runs it). Every count is
an integer below 2^24, so both histograms must be equal exactly. The curve modules in sketch mode
are then held against the JAX modules on one seeded stream. The JAX package is imported inside a
fixture, so that the card tests at the end also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_sketch_update.py -m cuda
"""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.ops import hist_pair as k2

KINDS = ["binary", "multiclass", "multiclass_micro", "multilabel"]
NUM_CLASSES = 3


@pytest.fixture(scope="module")
def jax():
    """The JAX side, with its histogram pair on the Pallas kernel in interpret mode."""
    jnp = pytest.importorskip("jax.numpy")
    from torchmetrics_tpu.ops import histogram

    histogram.set_bincount_backend("pallas")
    yield SimpleNamespace(
        jnp=jnp,
        prc=importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve"),
        hist=importlib.import_module("torchmetrics_tpu.sketch.hist"),
        classification=importlib.import_module("torchmetrics_tpu.classification"),
    )
    histogram.set_bincount_backend("xla")


def _scores(rng, shape, bins):
    """Scores with some on bucket edges ``k/(bins-1)`` and just beside them, and NaN, ±inf, -0.5, 1.5."""
    scores = rng.rand(*shape).astype(np.float32)
    flat = scores.reshape(-1)
    edges = (np.arange(bins, dtype=np.float32) / np.float32(bins - 1)).astype(np.float32)
    on = rng.randint(0, flat.size, flat.size // 4)
    flat[on] = edges[rng.randint(0, bins, on.size)]
    flat[on[::3]] = np.nextafter(flat[on[::3]], np.float32(-1))
    special = np.array([np.nan, np.inf, -np.inf, -0.5, 1.5, 0.0, 1.0], np.float32)[:flat.size]
    flat[:special.size] = special
    return scores


def _inputs(kind, n, bins, seed, ignore_index=None, labels=(0, 1), num_classes=NUM_CLASSES):
    """Scores, a target, and an old state of integer counts, as numpy arrays."""
    rng = np.random.RandomState(seed)
    per_class = kind != "binary"
    scores = _scores(rng, (n, num_classes) if per_class else (n,), bins)
    if kind in ("multiclass", "multiclass_micro"):
        target = rng.randint(0, num_classes, n)
    else:
        target = np.asarray(labels)[rng.randint(0, len(labels), scores.shape)]
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.15] = ignore_index
    hist_shape = (num_classes, bins) if kind in ("multiclass", "multilabel") else (bins,)
    old = [rng.randint(0, 50, hist_shape).astype(np.float32) for _ in range(2)]
    return scores, target, old


def _jax_update(jax, kind, scores, target, old, ignore_index):
    """The JAX package's sketch branch: its ``_format`` weights, then ``hist_update_pair`` or
    ``hist_update_classes``. The scores are given as they are (``_format`` would map scores outside
    [0, 1] through a sigmoid), so that NaN, ±inf and the bucket edges reach the buckets."""
    jnp, prc, sh = jax.jnp, jax.prc, jax.hist
    s, t, pos_old, neg_old = jnp.asarray(scores), jnp.asarray(target), jnp.asarray(old[0]), jnp.asarray(old[1])
    if kind == "binary":
        _, t01, w, _ = prc._binary_precision_recall_curve_format(s, t, None, ignore_index)
        t01 = t01.astype(jnp.float32)
        return sh.hist_update_pair(pos_old, neg_old, s, w * t01, w * (1.0 - t01))
    if kind == "multilabel":
        _, t01, w, _ = prc._multilabel_precision_recall_curve_format(s, t, NUM_CLASSES, None, ignore_index)
        t01 = t01.astype(jnp.float32)
        return sh.hist_update_classes(pos_old, neg_old, s, t01 * w, (1.0 - t01) * w)
    if kind == "multiclass_micro":
        _, t01, w, _ = prc._multiclass_precision_recall_curve_format(s, t, NUM_CLASSES, None, ignore_index, "micro")
        t01 = t01.astype(jnp.float32)
        return sh.hist_update_pair(pos_old, neg_old, s.reshape(-1), w * t01, w * (1.0 - t01))
    _, tc_, w, _ = prc._multiclass_precision_recall_curve_format(s, t, NUM_CLASSES, None, ignore_index)
    pos = (tc_[:, None] == jnp.arange(NUM_CLASSES)[None, :]).astype(jnp.float32)
    return sh.hist_update_classes(pos_old, neg_old, s, pos * w[:, None], (1.0 - pos) * w[:, None])


def _ours(kind, scores, target, old, ignore_index, dtype=torch.int64):
    before = k2.SKETCH_UPDATE.launches
    out = k2.sketch_update(torch.from_numpy(scores), torch.from_numpy(target).to(dtype), torch.from_numpy(old[0]),
                           torch.from_numpy(old[1]), kind, ignore_index)
    assert k2.SKETCH_UPDATE.launches == before  # CPU tensors take the plain version
    return out


def _assert_pair_equal(ours, theirs):
    for got, want in zip(ours, theirs):
        assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("bins", [2, 2048, 4096])
@pytest.mark.parametrize("kind", KINDS)
def test_matches_jax_hist_update(jax, kind, bins, ignore_index, dtype):
    scores, target, old = _inputs(kind, 500, bins, seed=bins + len(kind), ignore_index=ignore_index)
    ours = _ours(kind, scores, target, old, ignore_index, dtype)
    _assert_pair_equal(ours, _jax_update(jax, kind, scores, target, old, ignore_index))
    _assert_pair_equal(ours, k2.sketch_update_plain(torch.from_numpy(scores), torch.from_numpy(target).to(dtype),
                                                    torch.from_numpy(old[0]), torch.from_numpy(old[1]), kind,
                                                    ignore_index))


@pytest.mark.parametrize("kind", ["binary", "multilabel"])
def test_target_outside_0_1_adds_t_and_1_minus_t(jax, kind):
    # with validate_args=False a target of 2 or -3 reaches the sketch: it adds t to the positive
    # histogram and 1 - t to the negative one, as the JAX package does
    scores, target, old = _inputs(kind, 400, 64, seed=9, ignore_index=-1, labels=(0, 1, 2, -3))
    ours = _ours(kind, scores, target, old, -1)
    _assert_pair_equal(ours, _jax_update(jax, kind, scores, target, old, -1))
    assert (ours[1] < torch.from_numpy(old[1])).any()  # some negative masses were negative


def test_rejects_what_the_kernel_does_not_take():
    scores, target, hist = torch.rand(8), torch.zeros(8, dtype=torch.int32), torch.zeros(16)
    with pytest.raises(ValueError, match="kind"):
        k2.sketch_update(scores, target, hist, hist, "multiclass_macro")
    with pytest.raises(ValueError, match="unexpected shapes"):
        k2.sketch_update(scores, target[:4], hist, hist, "binary")
    with pytest.raises(ValueError, match="unexpected shapes"):
        k2.sketch_update(scores.reshape(4, 2), target[:4], hist, hist, "multiclass")  # needs (C, bins) histograms
    with pytest.raises(TypeError, match="float32"):
        k2.sketch_update(scores.double(), target, hist, hist, "binary")
    with pytest.raises(TypeError, match="int32 or int64"):
        k2.sketch_update(scores, target.float(), hist, hist, "binary")
    with pytest.raises(TypeError, match="histograms"):
        k2.sketch_update(scores, target, hist, hist[:8], "binary")


def test_empty_batch_keeps_the_state():
    hist = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    pos, neg = k2.sketch_update(torch.empty(0, 3), torch.empty(0, dtype=torch.int64), hist, hist + 1, "multiclass")
    assert torch.equal(pos, hist) and torch.equal(neg, hist + 1)


def _stream(kind, seed, ignore_index=None, n_batches=3, batch=200):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        if kind == "binary":
            preds = rng.rand(batch).astype(np.float32)
            target = (rng.rand(batch) < np.clip(preds * 0.8 + 0.1, 0, 1)).astype(np.int64)
        elif kind == "multiclass":
            logits = rng.randn(batch, NUM_CLASSES).astype(np.float32)
            preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
            target = rng.randint(0, NUM_CLASSES, batch)
        else:
            preds = rng.rand(batch, NUM_CLASSES).astype(np.float32)
            target = (rng.rand(batch, NUM_CLASSES) < preds).astype(np.int64)
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.1] = ignore_index
        out.append((preds, target))
    return out


MODULES = {
    "binary-auroc": ("BinaryAUROC", {}, "binary"),
    "binary-ap-ignore": ("BinaryAveragePrecision", {"ignore_index": -1}, "binary"),
    "mc-auroc-macro": ("MulticlassAUROC", {"num_classes": NUM_CLASSES}, "multiclass"),
    "mc-ap-weighted-ignore": ("MulticlassAveragePrecision", {"num_classes": NUM_CLASSES, "average": "weighted",
                                                             "ignore_index": -1}, "multiclass"),
    "mc-roc-micro-ignore": ("MulticlassROC", {"num_classes": NUM_CLASSES, "average": "micro", "ignore_index": -1},
                            "multiclass"),
    "ml-auroc-ignore": ("MultilabelAUROC", {"num_labels": NUM_CLASSES, "ignore_index": -1}, "multilabel"),
    "ml-ap-macro": ("MultilabelAveragePrecision", {"num_labels": NUM_CLASSES}, "multilabel"),
}


@pytest.mark.parametrize("case", list(MODULES))
def test_sketch_modules_match_jax(jax, case):
    name, kwargs, kind = MODULES[case]
    kwargs = {**kwargs, "approx": "sketch"}
    ours, theirs = getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs)
    for preds, target in _stream(kind, seed=len(case), ignore_index=kwargs.get("ignore_index")):
        _assert_close(ours(preds, target), theirs(preds, target))
    for key, value in ours.metric_state.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(theirs.metric_state[key]), err_msg=key)
    _assert_close(ours.compute(), theirs.compute())


def _assert_close(ours, theirs):
    """A value, or a tuple of curve tensors, within atol 1e-6 of the JAX package's."""
    if isinstance(ours, (tuple, list)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _assert_close(a, b)
        return
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-6)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


def _on(device, scores, target, old, dtype):
    return (torch.from_numpy(scores).to(device), torch.from_numpy(target).to(device=device, dtype=dtype),
            torch.from_numpy(old[0]).to(device), torch.from_numpy(old[1]).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sketch_update_matches_plain_on_cuda(cuda_device, dtype):
    before = k2.SKETCH_UPDATE.launches
    launched = 0
    for kind in KINDS:
        for classes in ((1,) if kind == "binary" else (3, 20)):  # 20 labels of 2048 bins: two class groups
            # bins = 40,000: one class is wider than shared memory, so the state is cut into more slices
            for n, bins in ((1, 2), (4097, 2048), (65_536, 2048), (1_000_003, 2048), (5000, 40_000)):
                for ignore_index in (None, -1):
                    scores, target, old = _inputs(kind, n, bins, seed=n + bins, ignore_index=ignore_index,
                                                  labels=(0, 1, 2) if n == 4097 else (0, 1), num_classes=classes)
                    if dtype == torch.int64:
                        target[::7] += 2**32  # the int32 cast wraps it, as target.to(torch.int32) does
                    args = _on(cuda_device, scores, target, old, dtype)
                    got = k2.sketch_update(*args, kind, ignore_index)
                    want = k2.sketch_update_plain(*args, kind, ignore_index)
                    launched += 1
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (kind, classes, n, bins, ignore_index)
    torch.cuda.synchronize()
    assert k2.SKETCH_UPDATE.launches == before + launched


@pytest.mark.cuda
def test_scratch_resets_between_calls_and_streams(cuda_device):
    scores, target, old = _inputs("binary", 1_000_003, 2048, seed=4)
    args = _on(cuda_device, scores, target, old, torch.int32)
    want = k2.sketch_update_plain(*args, "binary")
    for _ in range(2):  # the first call left its scratch clean
        assert all(torch.equal(g, w) for g, w in zip(k2.sketch_update(*args, "binary"), want))
    idx = torch.from_numpy(np.random.RandomState(5).randint(0, 2048, 1_000_003).astype(np.int32)).to(cuda_device)
    pos = (args[1] == 1).float()
    want_pair = k2.hist_pair_plain(idx, pos, 1.0 - pos, 2048)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = []
    for _ in range(3):
        for stream in streams:  # calls on two streams may overlap: each stream has its own scratch
            stream.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(stream):
                outs.append((k2.sketch_update(*args, "binary"), k2.hist_pair(idx, pos, 1.0 - pos, 2048)))
    torch.cuda.synchronize()
    for sketch, pair in outs:
        assert all(torch.equal(g, w) for g, w in zip(sketch, want))
        assert torch.equal(pair, want_pair)


@pytest.mark.cuda
def test_hist_pair_and_sketch_update_replay_in_a_cuda_graph(cuda_device):
    rng = np.random.RandomState(6)
    n, bins = 100_000, 2048
    scores = torch.from_numpy(rng.rand(n, NUM_CLASSES).astype(np.float32)).to(cuda_device)
    target = torch.from_numpy(rng.randint(0, NUM_CLASSES, n).astype(np.int64)).to(cuda_device)
    pos_old = torch.zeros((NUM_CLASSES, bins), device=cuda_device)
    neg_old = torch.ones((NUM_CLASSES, bins), device=cuda_device)
    idx = torch.from_numpy(rng.randint(0, bins, n).astype(np.int32)).to(cuda_device)
    w = torch.from_numpy((rng.rand(n) < 0.5).astype(np.float32)).to(cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):  # warm-up: build and load the kernel outside the capture
        k2.sketch_update(scores, target, pos_old, neg_old, "multiclass", -1)
        k2.hist_pair(idx, w, 1.0 - w, bins)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new_pos, new_neg = k2.sketch_update(scores, target, pos_old, neg_old, "multiclass", -1)
        pair = k2.hist_pair(idx, w, 1.0 - w, bins)
    for step in range(3):
        scores.copy_(torch.from_numpy(rng.rand(n, NUM_CLASSES).astype(np.float32)))
        target.copy_(torch.from_numpy(rng.randint(-1, NUM_CLASSES, n).astype(np.int64)))
        idx.copy_(torch.from_numpy(rng.randint(0, bins, n).astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        want = k2.sketch_update_plain(scores, target, pos_old, neg_old, "multiclass", -1)
        assert torch.equal(new_pos, want[0]) and torch.equal(new_neg, want[1]), step
        assert torch.equal(pair, k2.hist_pair_plain(idx, w, 1.0 - w, bins)), step
