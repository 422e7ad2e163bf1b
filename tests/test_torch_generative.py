"""The port's generative image metrics (``image/generative.py``) against the JAX package's.

The same seeded numpy features, images and tiny in-process torch networks go to both packages: JAX
gets each network through a numpy wrapper, the port the module itself (as
``tests/unittests/test_tiny_model_cross_parity.py`` hands one model to two pipelines). Tolerances:

- FID and MiFID: the port computes in float64 from JAX's float32 states, so it is held to a float64
  scipy oracle within rtol 1e-5 and to JAX's float32 value within rtol 1e-3 (JAX's float32 ``eigh``
  at d = 16-64); each compensated state (sum plus compensation) equals JAX's within 1e-6 of its largest
  entry (the compensations alone hold rounding errors, which depend on the order of the adds);
  the port's float32 formula within rtol 1e-3 of JAX's ``_compute_fid`` on the same inputs;
- KID, IS and LPIPS: JAX's values within rtol 1e-5 (KID's mean 1e-4, its std 1e-3: a spread of
  differences of large kernel sums); PPL within rtol 1e-4 (a distance divides a difference of images
  of nearby latents by ε², so one rounding of a latent, 6e-8 of it, is about 1e-5 of the distance at
  ε = 1e-2, and JAX's compiled interpolation rounds differently), its discards keeping JAX's elements;
- every error is JAX's type and message.
"""
from __future__ import annotations

import numpy as np
import pytest
import scipy.linalg
import torch
from torch import nn

import torchmetrics_tpu_torch.image as pi
from torchmetrics_tpu_torch.image import generative as pg

D = 16


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.image as ji
    import torchmetrics_tpu.image.generative as jg

    return ji, jg, jnp


def _feats(seed: int, n: int, d: int = D, loc: float = 0.0, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n, d) * scale + loc).astype(np.float32)


def fid_np(f_real: np.ndarray, f_fake: np.ndarray) -> float:
    f_real, f_fake = f_real.astype(np.float64), f_fake.astype(np.float64)
    mu1, mu2 = f_real.mean(0), f_fake.mean(0)
    cov1, cov2 = np.cov(f_real, rowvar=False), np.cov(f_fake, rowvar=False)
    covmean = scipy.linalg.sqrtm(cov1 @ cov2).real
    return float(((mu1 - mu2) ** 2).sum() + np.trace(cov1 + cov2 - 2 * covmean))


class TinyFeatureNet(nn.Module):
    """Stands in for InceptionV3: uint8 ``(N, 3, H, W)`` -> ``(N, d)``."""

    def __init__(self, d: int = 64) -> None:  # FID's width in the test of the states: one JAX compile of the compute
        super().__init__()
        torch.manual_seed(3)
        self.net = nn.Sequential(nn.Conv2d(3, 8, 3, stride=2), nn.ReLU(), nn.AdaptiveAvgPool2d(2), nn.Flatten(),
                                 nn.Linear(32, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.net(x.float() / 255.0)


class TinyDistanceNet(nn.Module):
    """An LPIPS-shaped distance: unit-normalised conv features, weighted squared differences,
    spatial means: ``(img1, img2) -> (N,)``."""

    def __init__(self) -> None:
        super().__init__()
        torch.manual_seed(5)
        self.conv = nn.Conv2d(3, 6, 3, padding=1)
        self.lin = nn.Conv2d(6, 1, 1, bias=False)
        with torch.no_grad():
            self.lin.weight.abs_()

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            fa, fb = torch.relu(self.conv(a)), torch.relu(self.conv(b))
            fa = fa / (fa.norm(dim=1, keepdim=True) + 1e-10)
            fb = fb / (fb.norm(dim=1, keepdim=True) + 1e-10)
            return self.lin((fa - fb) ** 2).mean(dim=(1, 2, 3))


class TinyGenerator(nn.Module):
    """4-d latents (and labels of 3 classes) -> images of 3 x 8 x 8 in [0, 255]; ``sample`` draws from
    its own seeded stream, so two generators of one seed give the same latents."""

    num_classes = 3

    def __init__(self, seed: int = 7, to_numpy: bool = False) -> None:
        super().__init__()
        torch.manual_seed(9)
        self.fc = nn.Linear(4, 3 * 8 * 8)
        self.embed = nn.Embedding(3, 4)
        self.rng = np.random.RandomState(seed)
        self.to_numpy = to_numpy

    def sample(self, n: int):
        z = self.rng.randn(n, 4).astype(np.float32)
        return z if self.to_numpy else torch.from_numpy(z)

    def forward(self, z, labels=None):
        z = torch.as_tensor(np.asarray(z))
        with torch.no_grad():
            if labels is not None:
                z = z + self.embed(torch.as_tensor(np.asarray(labels)).long())
            img = 255 * torch.sigmoid(self.fc(z)).reshape(-1, 3, 8, 8)
        return img.numpy() if self.to_numpy else img


def _jax_callable(module, jnp):
    """The module as JAX's ``feature`` / ``sim_net`` / generator: numpy in, numpy through torch, jnp out."""

    def call(*arrays):
        out = module(*(torch.as_tensor(np.asarray(a)) for a in arrays))
        return jnp.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)

    return call


class _JaxGenerator:
    def __init__(self, gen: TinyGenerator, jnp) -> None:
        self.gen, self.jnp, self.num_classes = gen, jnp, gen.num_classes

    def sample(self, n):
        return self.gen.sample(n)

    def __call__(self, z, labels=None):
        return self.jnp.asarray(self.gen(np.asarray(z), None if labels is None else np.asarray(labels)))


def _both(jx, name, jax_kwargs, port_kwargs=None):
    ji, _, _ = jx
    return getattr(ji, name)(**jax_kwargs), getattr(pi, name)(device="cpu", **(port_kwargs or jax_kwargs))


def _close(port_value, jax_value, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(port_value.detach().numpy(), np.float64), np.asarray(jax_value, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("d, loc", [(16, 2.0), (64, 10.0)])
def test_fid_states_and_value(jx, d, loc):
    """Compensated float32 states over many batches equal JAX's; the float64 compute equals scipy's
    (at d = 16 against scipy alone: JAX's compile of each shape costs more than the check)."""
    _, _, jnp = jx
    f_real, f_fake = _feats(1, 600, d, loc), _feats(2, 400, d, loc + 0.3, 0.8)
    pm = pi.FrechetInceptionDistance(feature=None, num_features=d, device="cpu")
    for chunks, real in ((np.split(f_real, 6), True), (np.split(f_fake, 4), False)):
        for c in chunks:
            pm.update(torch.from_numpy(c), real=real)
    value = pm.compute()
    assert value.dtype == torch.float32 and len(pm.metric_state) == 14
    np.testing.assert_allclose(float(value), fid_np(f_real, f_fake), rtol=1e-5)
    if d == 16:
        return
    jm = jx[0].FrechetInceptionDistance(feature=None, num_features=d)
    for chunks, real in ((np.split(f_real, 6), True), (np.split(f_fake, 4), False)):  # one shape: one JAX compile
        for c in chunks:
            jm.update(jnp.asarray(c), real=real)
    ps, js = pm.metric_state, {k: np.asarray(v, np.float64) for k, v in jm.metric_state.items()}
    assert sorted(ps) == sorted(js) and len(ps) == 14
    for name, state in js.items():  # the compensations hold rounding errors, which depend on the order
        if not name.endswith("_comp"):
            corrected = ps[name].double() + ps.get(name + "_comp", torch.zeros(())).double()
            _close(corrected, state + js.get(name + "_comp", 0.0), 1e-6, 1e-6 * np.abs(state).max())
    np.testing.assert_allclose(float(value), float(jm.compute()), rtol=1e-3)


def test_compute_fid_float32_formula_matches_jax(jx):
    _, jg, jnp = jx
    f_real, f_fake = _feats(3, 400, 64), _feats(4, 400, 64, 0.5, 1.2)
    args = [f_real.mean(0), np.cov(f_real, rowvar=False), f_fake.mean(0), np.cov(f_fake, rowvar=False)]
    args = [a.astype(np.float32) for a in args]
    got = pg._compute_fid(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32
    _close(got, jg._compute_fid(*(jnp.asarray(a) for a in args)), 1e-3)
    np.testing.assert_allclose(float(pg._compute_fid(*(torch.from_numpy(a).double() for a in args))),
                               fid_np(f_real, f_fake), rtol=1e-4)


def test_fid_extractor_normalize_forward_and_reset(jx):
    """A tiny CNN as ``feature`` (JAX through numpy, the port the module), ``normalize=True`` on [0, 1]
    floats, ``update_batches``, the forward's guard and ``reset_real_features=False``."""
    _, _, jnp = jx
    net = TinyFeatureNet()
    rng = np.random.RandomState(5)
    real = rng.randint(0, 256, (3, 6, 3, 16, 16)).astype(np.uint8)
    fake = rng.rand(2, 6, 3, 16, 16).astype(np.float32)
    jm, pm = _both(jx, "FrechetInceptionDistance", {"feature": _jax_callable(net, jnp), "reset_real_features": False},
                   {"feature": net, "reset_real_features": False})
    assert pm.metric_state["real_features_sum"].shape == (64,)  # the probe on zeros(1, 3, 299, 299)
    jm.update_batches(jnp.asarray(real), real=True)
    pm.update_batches(torch.from_numpy(real), real=True)
    jn, pn = _both(jx, "FrechetInceptionDistance", {"feature": _jax_callable(net, jnp), "normalize": True},
                   {"feature": net, "normalize": True})
    for m_j, m_p in ((jm, pm), (jn, pn)):
        for batch in fake:
            m_j.update(jnp.asarray(batch), real=False)
            m_p.update(torch.from_numpy(batch), real=False)
    np.testing.assert_allclose(float(pm.compute()), float(jm.compute()), rtol=1e-3)
    _close(pn.metric_state["fake_features_sum"], jn.metric_state["fake_features_sum"], 1e-5, 1e-5)
    with pytest.raises(RuntimeError, match="More than one sample"):
        pm(torch.from_numpy(real[0]), real=True)
    n_real = pm.metric_state["real_features_num_samples"].clone()
    pm.reset()
    assert float(pm.metric_state["real_features_num_samples"]) == float(n_real) == 24  # 18 and the forward's 6
    assert float(pm.metric_state["fake_features_num_samples"]) == 0


def _kid_np(f_real, f_fake, subsets, m, seed):
    """KID in float64 numpy over the subsets ``RandomState(seed)`` draws, JAX's order."""
    rng = np.random.RandomState(seed)
    scores = []
    for _ in range(subsets):
        fr = f_real[rng.permutation(len(f_real))[:m]].astype(np.float64)
        ff = f_fake[rng.permutation(len(f_fake))[:m]].astype(np.float64)
        k11, k22, k12 = ((a @ b.T / f_real.shape[1] + 1.0) ** 3 for a, b in ((fr, fr), (ff, ff), (fr, ff)))
        scores.append((k11.sum() - np.trace(k11) + k22.sum() - np.trace(k22)) / (m * (m - 1)) - 2 * k12.sum() / m**2)
    return np.mean(scores), np.std(scores)


@pytest.mark.parametrize("subset_size, seed", [(60, None), (25, 123)])
def test_kid_matches_jax(jx, subset_size, seed):
    """``subset_size < n`` with a seed against JAX's subsets; ``== n`` (every subset a permutation of
    the whole set, whatever the seed) against float64 numpy."""
    _, _, jnp = jx
    f_real, f_fake = _feats(6, 60, D), _feats(7, 70 if subset_size < 60 else 60, D, 0.4)
    kwargs = {"feature": None, "subsets": 5, "subset_size": subset_size, "seed": seed}
    pm = pi.KernelInceptionDistance(device="cpu", **kwargs)
    for f, real in ((f_real[:30], True), (f_real[30:], True), (f_fake, False)):
        pm.update(torch.from_numpy(f), real=real)
    pmean, pstd = pm.compute()
    if subset_size == 60:
        want_mean, want_std = _kid_np(f_real, f_fake, 5, 60, 0)
        np.testing.assert_allclose(float(pmean), want_mean, rtol=1e-4)
        np.testing.assert_allclose(float(pstd), want_std, rtol=1e-3, atol=1e-6)
        return
    jm = jx[0].KernelInceptionDistance(**kwargs)
    for f, real in ((f_real, True), (f_fake, False)):
        jm.update(jnp.asarray(f), real=real)
    jmean, jstd = jm.compute()
    _close(pmean, jmean, 1e-4)
    _close(pstd, jstd, 1e-3, 1e-6)
    np.testing.assert_allclose(float(pmean), _kid_np(f_real, f_fake, 5, subset_size, seed)[0], rtol=1e-4)


def test_kid_batched_chunks_equal_one_chunk(monkeypatch):
    """Scoring the subsets in chunks (``BLOCK_BYTES`` shrunk to one subset a chunk) gives the bits of
    one batched call."""
    f_real, f_fake = torch.from_numpy(_feats(8, 40)), torch.from_numpy(_feats(9, 40, loc=0.2))
    values = []
    for block in (pg.BLOCK_BYTES, 1):
        monkeypatch.setattr(pg, "BLOCK_BYTES", block)
        m = pi.KernelInceptionDistance(feature=None, subsets=6, subset_size=20, seed=4, device="cpu")
        m.update(f_real, real=True)
        m.update(f_fake, real=False)
        values.append([v.numpy().tobytes() for v in m.compute()])
    assert values[0] == values[1]


@pytest.mark.parametrize("splits", [1, 3])
def test_inception_score_matches_jax(jx, splits):
    _, _, jnp = jx
    logits = (np.random.RandomState(10).randn(48, 10) * 4).astype(np.float32)
    jm, pm = _both(jx, "InceptionScore", {"feature": None, "splits": splits, "seed": 7})
    jm.update(jnp.asarray(logits))
    pm.update(torch.from_numpy(logits))
    (jmean, jstd), (pmean, pstd) = jm.compute(), pm.compute()
    _close(pmean, jmean, 1e-5)
    if splits == 1:
        assert np.isnan(float(pstd)) and np.isnan(float(jstd))  # ddof 1 over one chunk
    else:
        _close(pstd, jstd, 1e-4)


def test_mifid_matches_jax_and_memorisation_penalised(jx):
    _, _, jnp = jx
    f_real = np.abs(_feats(11, 200, D, 1.0, 0.5))
    f_fake = np.concatenate([f_real[:100] + 0.01 * _feats(12, 100, D), np.abs(_feats(13, 100, D, 1.0, 0.5))])
    f_fake[3] = 0.0  # an all-zero row, dropped by the cosine search
    jm, pm = _both(jx, "MemorizationInformedFrechetInceptionDistance", {"feature": None})
    for f, real in ((f_real, True), (f_fake, False)):
        jm.update(jnp.asarray(f), real=real)
        pm.update(torch.from_numpy(f), real=real)
    value = pm.compute()
    _close(value, jm.compute(), 1e-3)
    distance = pg._cosine_distance(torch.from_numpy(f_real), torch.from_numpy(f_fake))
    assert float(distance) < 0.1  # the penalty is on
    np.testing.assert_allclose(float(value), fid_np(f_real, f_fake) / float(distance), rtol=1e-5)


def test_cosine_distance_in_blocks_matches_jax(jx, monkeypatch):
    _, jg, jnp = jx
    a, b = _feats(14, 37, D, 0.5), _feats(15, 23, D, 0.5)
    want = jg._cosine_distance(jnp.asarray(a), jnp.asarray(b), eps=0.5)
    for block in (pg.BLOCK_BYTES, 4 * 23 * 5):  # whole, and blocks of 5 rows
        monkeypatch.setattr(pg, "BLOCK_BYTES", block)
        _close(pg._cosine_distance(torch.from_numpy(a), torch.from_numpy(b), eps=0.5), want, 1e-6)


@pytest.mark.parametrize("reduction, normalize", [("mean", False), ("sum", False), ("mean", True)])
def test_lpips_matches_jax(jx, reduction, normalize):
    _, _, jnp = jx
    net = TinyDistanceNet()
    rng = np.random.RandomState(16)
    batches = [(rng.rand(4, 3, 12, 12).astype(np.float32), rng.rand(4, 3, 12, 12).astype(np.float32)) for _ in range(2)]
    jm, pm = _both(jx, "LearnedPerceptualImagePatchSimilarity",
                   {"net_type": _jax_callable(net, jnp), "reduction": reduction, "normalize": normalize},
                   {"net_type": net, "reduction": reduction, "normalize": normalize})
    for a, b in batches:
        _close(pm(torch.from_numpy(a), torch.from_numpy(b)), jm(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    _close(pm.compute(), jm.compute(), 1e-5)
    assert float(pm.metric_state["total"]) == 8


@pytest.mark.parametrize("method, conditional", [("lerp", False), ("slerp_any", False), ("slerp_unit", False),
                                                 ("lerp", True)])
def test_ppl_matches_jax(jx, method, conditional):
    """The functional with both discards and the class without, against JAX's on the same generator
    and net."""
    ji, _, jnp = jx
    net = TinyDistanceNet()
    kwargs = dict(num_samples=101, batch_size=51, interpolation_method=method, epsilon=1e-2, conditional=conditional)
    jmean, jstd, jkept = ji.perceptual_path_length(_JaxGenerator(TinyGenerator(to_numpy=True), jnp),
                                                   sim_net=_jax_callable(net, jnp), **kwargs)
    pmean, pstd, pkept = pi.perceptual_path_length(TinyGenerator(), sim_net=net, **kwargs)
    _close(pkept, jkept, 1e-4)
    _close(pmean, jmean, 1e-4)
    _close(pstd, jstd, 1e-4)
    m = pi.PerceptualPathLength(sim_net=net, lower_discard=None, upper_discard=None, device="cpu", **kwargs)
    m.update(TinyGenerator())
    jm = ji.PerceptualPathLength(sim_net=_jax_callable(net, jnp), lower_discard=None, upper_discard=None, **kwargs)
    jm.update(_JaxGenerator(TinyGenerator(to_numpy=True), jnp))
    for got, want in zip(m.compute(), jm.compute()):
        _close(got, want, 1e-4)


def test_ppl_lower_quantile_index_is_jax_s(jx):
    """``floor(q (n - 1))`` in float32, as ``jnp.quantile(method="lower")`` takes it: at q = 0.7 and n = 91
    the product is 62.99999999999999 in float64 and 63 in float32, so a float64 index would differ."""
    _, _, jnp = jx
    cases = [(0.01, 2), (0.01, 101), (0.99, 10_001), (0.3, 11), (0.7, 91), (0.7, 101), (0.7, 171), (0.7, 1301)]
    differs = 0
    for q, n in cases:
        want = int(jnp.quantile(jnp.arange(n, dtype=jnp.float32), q, method="lower"))
        assert pg._lower_quantile_index(q, n) == want, (q, n)
        differs += int(np.floor(q * (n - 1))) != want
    assert differs == 3  # (0.7, 91), (0.7, 171), (0.7, 1301)


def test_ppl_discard_at_a_float32_rounded_index(jx):
    """PPL's upper discard at q = 0.7 over 91 distances keeps JAX's 64 elements (a float64 index, 63)."""
    ji, _, jnp = jx
    net = TinyDistanceNet()
    kwargs = dict(num_samples=91, batch_size=91, epsilon=1e-2, lower_discard=None, upper_discard=0.7)
    *_, jkept = ji.perceptual_path_length(_JaxGenerator(TinyGenerator(to_numpy=True), jnp),
                                          sim_net=_jax_callable(net, jnp), **kwargs)
    *_, pkept = pi.perceptual_path_length(TinyGenerator(), sim_net=net, **kwargs)
    assert pkept.shape == jkept.shape == (64,)
    _close(pkept, jkept, 1e-4)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_generative_errors_match_jax(jx):
    """Each guard and message of JAX's, from the constructors, updates and computes."""
    ji, _, jnp = jx
    cases = [
        ("FrechetInceptionDistance", {"feature": 100}),
        ("FrechetInceptionDistance", {"feature": 2048}),
        ("FrechetInceptionDistance", {"feature": "logits_unbiased"}),
        ("FrechetInceptionDistance", {"feature": None}),
        ("FrechetInceptionDistance", {"feature": 3.5}),
        ("FrechetInceptionDistance", {"feature": None, "num_features": 4, "normalize": 1}),
        ("FrechetInceptionDistance", {"feature": None, "num_features": 4, "reset_real_features": "no"}),
        ("KernelInceptionDistance", {"feature": 64}),
        ("KernelInceptionDistance", {"feature": None, "subsets": 0}),
        ("KernelInceptionDistance", {"feature": None, "subset_size": -1}),
        ("KernelInceptionDistance", {"feature": None, "degree": 1.5}),
        ("KernelInceptionDistance", {"feature": None, "gamma": 2}),
        ("KernelInceptionDistance", {"feature": None, "coef": 1}),
        ("InceptionScore", {}),
        ("InceptionScore", {"feature": "logits"}),
        ("InceptionScore", {"feature": None, "normalize": "yes"}),
        ("MemorizationInformedFrechetInceptionDistance", {"feature": 768}),
        ("MemorizationInformedFrechetInceptionDistance", {"feature": None, "cosine_distance_eps": 1.5}),
        ("LearnedPerceptualImagePatchSimilarity", {"net_type": "alex"}),
        ("LearnedPerceptualImagePatchSimilarity", {"net_type": "resnet"}),
        ("LearnedPerceptualImagePatchSimilarity", {"net_type": 3}),
        ("LearnedPerceptualImagePatchSimilarity", {"net_type": lambda a, b: a, "reduction": "max"}),
        ("LearnedPerceptualImagePatchSimilarity", {"net_type": lambda a, b: a, "normalize": 1}),
    ]
    for name, kwargs in cases:
        with pytest.raises(Exception) as jerr:
            getattr(ji, name)(**kwargs)
        with pytest.raises(type(jerr.value)) as perr:
            getattr(pi, name)(device="cpu", **kwargs)
        assert str(perr.value) == str(jerr.value), (name, kwargs)

    def raises_alike(jcall, pcall):
        with pytest.raises(Exception) as jerr:
            jcall()
        with pytest.raises(type(jerr.value)) as perr:
            pcall()
        assert str(perr.value) == str(jerr.value)

    for name in ("KernelInceptionDistance", "InceptionScore", "MemorizationInformedFrechetInceptionDistance"):
        raises_alike(lambda: getattr(ji, name)(feature=None).compute(),
                     lambda: getattr(pi, name)(feature=None, device="cpu").compute())
    few = _feats(17, 1)
    jf, pf = _both(jx, "FrechetInceptionDistance", {"feature": None, "num_features": D})
    jk, pk = _both(jx, "KernelInceptionDistance", {"feature": None, "subset_size": 100})
    for (jm, pm) in ((jf, pf), (jk, pk)):
        for real in (True, False):
            jm.update(jnp.asarray(few), real=real)
            pm.update(torch.from_numpy(few), real=real)
        raises_alike(jm.compute, pm.compute)
    gen_j, gen_p = _JaxGenerator(TinyGenerator(to_numpy=True), jnp), TinyGenerator()
    sim = TinyDistanceNet()
    for kwargs in ({"sim_net": None}, {"num_samples": 0}, {"epsilon": 1}, {"batch_size": 0}, {"lower_discard": 2.0},
                   {"upper_discard": 1}, {"interpolation_method": "cubic"}):
        call_kwargs = {"num_samples": 8, "sim_net": sim, **kwargs}
        raises_alike(lambda: ji.perceptual_path_length(gen_j, **{**call_kwargs, "sim_net": call_kwargs["sim_net"] and _jax_callable(sim, jnp)}),
                     lambda: pi.perceptual_path_length(gen_p, **call_kwargs))
    raises_alike(lambda: ji.perceptual_path_length(object(), sim_net=_jax_callable(sim, jnp)),
                 lambda: pi.perceptual_path_length(object(), sim_net=sim))
    raises_alike(lambda: ji.perceptual_path_length(type("G", (), {"sample": lambda s, n: n})(), conditional=True,
                                                   sim_net=_jax_callable(sim, jnp)),
                 lambda: pi.perceptual_path_length(type("G", (), {"sample": lambda s, n: n})(), conditional=True,
                                                   sim_net=sim))
