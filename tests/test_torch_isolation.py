"""The PyTorch port stands alone: it imports neither JAX nor the JAX package, and its metrics run
on CUDA unless the caller names another device."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "torchmetrics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "profile_port.py"]
FORBIDDEN = ("jax", "jaxlib", "torchmetrics_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (  # every module of the package, the slices' new ones included
        "import importlib, pkgutil, sys\n"
        "import torchmetrics_tpu_torch\n"
        "for m in pkgutil.walk_packages(torchmetrics_tpu_torch.__path__, 'torchmetrics_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for name in ('functional.classification.calibration_error', 'aggregation', 'ops.dispatch', 'wrappers.running',\n"
        "             'parallel.sync', 'wrappers.bootstrapping', 'wrappers.tracker', 'wrappers.multitask',\n"
        "             'clustering.metrics', 'nominal.metrics', 'functional.clustering.extrinsic',\n"
        "             'functional.clustering.intrinsic', 'functional.nominal.cramers', 'functional.nominal.fleiss_kappa',\n"
        "             'sketch.kll', 'sketch.countmin', 'sketch.metrics', 'keyed.engine', 'obs.telemetry',\n"
        "             'obs.flightrec', 'obs.timeseries', 'obs.slo', 'online.windowed', 'online.drift',\n"
        "             'functional.pairwise.distances', 'functional.image.ssim', 'functional.image.d_lambda',\n"
        "             'functional.image.vif', 'image.metrics', 'utils.precision', 'image.generative',\n"
        "             'utils.pretrained', 'audio.metrics', 'functional.audio.snr', 'functional.audio.sdr',\n"
        "             'functional.audio.pit', 'functional.audio.srmr', 'functional.audio.deps', 'text.metrics',\n"
        "             'functional.text._ngram', 'functional.text._edit', 'functional.text.edit', 'functional.text.wer',\n"
        "             'functional.text.bleu', 'functional.text.sacre_bleu', 'functional.text.chrf', 'functional.text.ter',\n"
        "             'functional.text.eed', 'functional.text.rouge', 'functional.text.squad',\n"
        "             'functional.text.perplexity', 'functional.text.bert', 'functional.text.infolm',\n"
        "             'multimodal.clip', 'functional.multimodal.clip', 'detection.helpers', 'detection.iou',\n"
        "             'detection.mean_ap', 'detection.panoptic_qualities', 'functional.detection.iou',\n"
        "             'functional.detection.panoptic'):\n"
        "    assert 'torchmetrics_tpu_torch.' + name in sys.modules, name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'torchmetrics_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path.name}:{node.lineno} imports {names}"


def test_metrics_default_to_cuda_and_raise_without_it(monkeypatch):
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
        MulticlassAccuracy(num_classes=3)
    with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
        MulticlassAccuracy(num_classes=3, device="cuda")
    assert MulticlassAccuracy(num_classes=3, device="cpu").device == torch.device("cpu")


def test_generative_and_audio_metrics_default_to_cuda(monkeypatch):
    """The slice's classes resolve their device as every metric does: CUDA unless told otherwise."""
    from torchmetrics_tpu_torch.audio import SignalNoiseRatio
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: FrechetInceptionDistance(feature=None, num_features=4, **kw),
                 lambda **kw: SignalNoiseRatio(**kw)):
        with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
            make()
        assert make(device="cpu").device == torch.device("cpu")


def test_text_entries_and_metrics_default_to_cuda(monkeypatch):
    """The text entries that take strings return their tensors on CUDA unless the caller names another
    device, as the text metrics keep their states there."""
    import torchmetrics_tpu_torch.functional as pf
    from torchmetrics_tpu_torch.text import BLEUScore
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda **kw: pf.bleu_score(["a b"], [["a b"]], **kw), lambda **kw: pf.char_error_rate(["ab"], ["ac"], **kw),
             lambda **kw: pf.edit_distance(["ab"], ["ac"], **kw), lambda **kw: pf.rouge_score("a b", "a c", **kw)["rouge1_fmeasure"],
             lambda **kw: pf.squad([{"prediction_text": "a", "id": "1"}],
                                   [{"answers": {"text": ["a"]}, "id": "1"}], **kw)["f1"],
             lambda **kw: pf.translation_edit_rate(["a b"], [["a c"]], **kw), lambda **kw: BLEUScore(**kw)]
    for call in calls:
        with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
            call()
        assert call(device="cpu").device == torch.device("cpu")


def test_encoder_backed_multimodal_and_detection_default_to_cuda(monkeypatch):
    """The slice's entries and classes resolve their device as every metric does: CUDA unless the caller
    names another (a tensor entry follows its inputs; numpy inputs go to CUDA)."""
    import numpy as np

    import torchmetrics_tpu_torch.functional as pf
    from torchmetrics_tpu_torch import BERTScore, CLIPScore, InfoLM, MeanAveragePrecision, PanopticQuality
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    def encoder(sentences):
        return np.ones((len(sentences), 2, 3), np.float32), np.ones((len(sentences), 2), np.int64)

    def masked_lm(sentences):
        return np.full((len(sentences), 2, 4), 0.25, np.float32), np.ones((len(sentences), 2), np.int64)

    clip = (lambda imgs: np.ones((len(imgs), 3), np.float32), lambda text: np.ones((len(text), 3), np.float32))
    maps = np.zeros((1, 2, 2, 2), np.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda **kw: pf.bert_score(["a"], ["a"], encoder=encoder, **kw)["f1"],
             lambda **kw: pf.infolm(["a"], ["a"], masked_lm=masked_lm, idf=False, **kw),
             lambda **kw: pf.clip_score([np.zeros((3, 2, 2), np.uint8)], ["a"], clip, **kw),
             lambda **kw: pf.panoptic_quality(maps, maps, things={1}, stuffs={0}, **kw),
             lambda **kw: BERTScore(encoder=encoder, **kw), lambda **kw: InfoLM(masked_lm=masked_lm, idf=False, **kw),
             lambda **kw: CLIPScore(clip, **kw), lambda **kw: MeanAveragePrecision(**kw),
             lambda **kw: PanopticQuality({1}, {0}, **kw)]
    for call in calls:
        with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
            call()
        assert call(device="cpu").device == torch.device("cpu")
