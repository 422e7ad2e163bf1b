"""The port's public names against the JAX package's, for the domains the port has ported.

Every class and function of ``torchmetrics_tpu.classification``, ``torchmetrics_tpu.regression``,
``torchmetrics_tpu.clustering``, ``torchmetrics_tpu.nominal`` and their ``functional`` modules, of
``functional.pairwise``, the image classes and entries (``image/metrics.py``, ``image/generative.py``,
``functional/image``), the audio domain (``audio``, ``functional.audio``), text, multimodal and detection
exists in the port under
the same name and in the same place; every name of ``torchmetrics_tpu.__all__`` and ``torchmetrics_tpu.functional.__all__``
whose domain is ported imports from the port's top level or ``functional``. The coverage meter
prints how many names of each ``__all__`` the port still lacks (run with ``-s`` to see it).
"""
from __future__ import annotations

import inspect

import pytest

import torchmetrics_tpu_torch as port
import torchmetrics_tpu_torch.audio as port_audio
import torchmetrics_tpu_torch.classification as port_classification
import torchmetrics_tpu_torch.clustering as port_clustering
import torchmetrics_tpu_torch.detection as port_detection
import torchmetrics_tpu_torch.functional as port_functional
import torchmetrics_tpu_torch.functional.audio as port_functional_audio
import torchmetrics_tpu_torch.functional.classification as port_functional_classification
import torchmetrics_tpu_torch.functional.clustering as port_functional_clustering
import torchmetrics_tpu_torch.functional.detection as port_functional_detection
import torchmetrics_tpu_torch.functional.image as port_functional_image
import torchmetrics_tpu_torch.functional.multimodal as port_functional_multimodal
import torchmetrics_tpu_torch.functional.nominal as port_functional_nominal
import torchmetrics_tpu_torch.functional.pairwise as port_functional_pairwise
import torchmetrics_tpu_torch.image as port_image
import torchmetrics_tpu_torch.functional.regression as port_functional_regression
import torchmetrics_tpu_torch.multimodal as port_multimodal
import torchmetrics_tpu_torch.nominal as port_nominal
import torchmetrics_tpu_torch.regression as port_regression
import torchmetrics_tpu_torch.text as port_text

#: the JAX package's modules whose names the port has ported, by domain
PORTED_MODULES = ("torchmetrics_tpu.classification", "torchmetrics_tpu.functional.classification",
                  "torchmetrics_tpu.regression", "torchmetrics_tpu.functional.regression", "torchmetrics_tpu.aggregation", "torchmetrics_tpu.retrieval", "torchmetrics_tpu.functional.retrieval",
                  "torchmetrics_tpu.metric", "torchmetrics_tpu.collections", "torchmetrics_tpu.wrappers",
                  "torchmetrics_tpu.clustering", "torchmetrics_tpu.functional.clustering", "torchmetrics_tpu.nominal",
                  "torchmetrics_tpu.functional.nominal", "torchmetrics_tpu.sketch", "torchmetrics_tpu.keyed",
                  "torchmetrics_tpu.online", "torchmetrics_tpu.functional.pairwise", "torchmetrics_tpu.functional.image",
                  "torchmetrics_tpu.image.metrics", "torchmetrics_tpu.image.generative", "torchmetrics_tpu.audio",
                  "torchmetrics_tpu.functional.audio", "torchmetrics_tpu.text.metrics",
                  "torchmetrics_tpu.functional.text.bleu", "torchmetrics_tpu.functional.text.chrf",
                  "torchmetrics_tpu.functional.text.edit", "torchmetrics_tpu.functional.text.eed",
                  "torchmetrics_tpu.functional.text.perplexity", "torchmetrics_tpu.functional.text.rouge",
                  "torchmetrics_tpu.functional.text.sacre_bleu", "torchmetrics_tpu.functional.text.squad",
                  "torchmetrics_tpu.functional.text.ter", "torchmetrics_tpu.functional.text.wer",
                  "torchmetrics_tpu.functional.text.bert", "torchmetrics_tpu.functional.text.infolm",
                  "torchmetrics_tpu.multimodal", "torchmetrics_tpu.functional.multimodal", "torchmetrics_tpu.detection",
                  "torchmetrics_tpu.functional.detection", "torchmetrics_tpu.serve")
#: the names of the ported modules above that still wait for a slice
WAITING: set = set()
#: names of ``torchmetrics_tpu.__all__`` that are modules or the version, not metrics
NOT_METRICS = {"functional", "obs", "robust", "__version__"}


@pytest.fixture(scope="module")
def jax_package():
    pytest.importorskip("jax")
    import torchmetrics_tpu
    import torchmetrics_tpu.functional

    return torchmetrics_tpu


def _public(module, kind):
    return {n for n in dir(module) if not n.startswith("_") and kind(getattr(module, n))}


def _ported(module, names):
    """The names of ``module`` whose object is defined in a ported domain."""
    return {n for n in names if n not in WAITING
            and (getattr(getattr(module, n), "__module__", "") or "").startswith(PORTED_MODULES)}


def test_every_classification_class_and_function_is_ported(jax_package):
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional.classification as jfc

    classes = _public(jc, inspect.isclass)
    functions = _public(jfc, inspect.isfunction)
    assert len(classes) == 90 and len(functions) == 89
    assert sorted(classes - set(port_classification.__all__)) == []
    assert sorted(functions - set(port_functional_classification.__all__)) == []
    for name in classes:
        assert inspect.isclass(getattr(port_classification, name)), name
    for name in functions:
        assert callable(getattr(port_functional_classification, name)), name


def test_every_regression_class_and_function_is_ported(jax_package):
    import torchmetrics_tpu.functional.regression as jfr
    import torchmetrics_tpu.regression as jr

    classes = _public(jr, inspect.isclass)
    functions = _public(jfr, inspect.isfunction)
    assert len(classes) == 18 and len(functions) == 18
    assert sorted(classes) == sorted(port_regression.__all__) and sorted(functions) == sorted(port_functional_regression.__all__)
    for name in classes:
        assert inspect.isclass(getattr(port_regression, name)), name
        assert getattr(port, name) is getattr(port_regression, name), name
    for name in functions:
        assert callable(getattr(port_functional_regression, name)), name
        assert getattr(port_functional, name) is getattr(port_functional_regression, name), name


@pytest.mark.parametrize("domain, n_classes, n_functions", [("clustering", 12, 13), ("nominal", 5, 9)])
def test_every_clustering_and_nominal_class_and_function_is_ported(jax_package, domain, n_classes, n_functions):
    """The 17 classes and 22 functional entries of clustering and nominal association, in their
    modules and at the top level (the functional top level holds JAX's 12 clustering and 9 nominal
    names: ``expected_mutual_info_score`` stays in ``functional.clustering``, as there)."""
    import importlib

    jax_classes = importlib.import_module(f"torchmetrics_tpu.{domain}")
    jax_functions = importlib.import_module(f"torchmetrics_tpu.functional.{domain}")
    ours = {"clustering": (port_clustering, port_functional_clustering), "nominal": (port_nominal, port_functional_nominal)}
    our_classes, our_functions = ours[domain]
    classes = _public(jax_classes, inspect.isclass)
    functions = _public(jax_functions, inspect.isfunction)
    assert len(classes) == n_classes and len(functions) == n_functions
    assert sorted(classes) == sorted(our_classes.__all__) and sorted(functions) == sorted(our_functions.__all__)
    for name in classes:
        assert getattr(port, name) is getattr(our_classes, name), name
    for name in functions:
        assert callable(getattr(our_functions, name)), name
        assert hasattr(port_functional, name) == hasattr(jax_package.functional, name), name
        if hasattr(port_functional, name):
            assert getattr(port_functional, name) is getattr(our_functions, name), name


def test_every_pairwise_and_image_quality_name_is_ported(jax_package):
    """The 5 pairwise entries, the 13 image entries and the 12 image-quality classes, in their modules,
    at the top level and in ``functional`` (where ``functional.__all__`` leaves out PSNR-B and VIF, as
    JAX's does); the generative classes are the next test's."""
    import torchmetrics_tpu.functional.image as jfi
    import torchmetrics_tpu.functional.pairwise as jfp
    import torchmetrics_tpu.image.metrics as jim

    for theirs, ours, n in ((jfp, port_functional_pairwise, 5), (jfi, port_functional_image, 13)):
        names = _public(theirs, inspect.isfunction)
        assert len(names) == n and sorted(names) == sorted(ours.__all__)
        for name in names:
            assert getattr(port_functional, name) is getattr(ours, name), name
            assert (name in port_functional.__all__) == (name in jax_package.functional.__all__), name
    classes = {n for n in _public(jim, inspect.isclass) if getattr(jim, n).__module__ == jim.__name__}
    quality = [n for n in port_image.__all__ if getattr(port_image, n).__module__ == "torchmetrics_tpu_torch.image.metrics"]
    assert len(classes) == 12 and sorted(classes) == sorted(quality)
    for name in classes:
        assert getattr(port, name) is getattr(port_image, name), name
        assert name in port.__all__


def test_every_generative_and_audio_name_is_ported(jax_package):
    """The 6 generative classes and ``perceptual_path_length`` (``image/generative.py``), the 10 audio
    classes and the 11 functional audio entries: in their modules, at the top level where JAX's top level
    has them, and in ``functional.__all__`` exactly where JAX's lists them (6 of the 11)."""
    import torchmetrics_tpu.audio as ja
    import torchmetrics_tpu.functional.audio as jfa
    import torchmetrics_tpu.image.generative as jg

    generative = {n for n in _public(jg, inspect.isclass) if getattr(jg, n).__module__ == jg.__name__
                  and not n.startswith("_")}
    assert len(generative) == 6 and generative <= set(port_image.__all__)
    assert port_image.perceptual_path_length is port.image.generative.perceptual_path_length
    audio_classes = _public(ja, inspect.isclass) - {"Metric"}
    audio_functions = _public(jfa, inspect.isfunction)
    assert len(audio_classes) == 10 and sorted(audio_classes) == sorted(port_audio.__all__)
    assert len(audio_functions) == 11 and sorted(audio_functions) == sorted(port_functional_audio.__all__)
    for name in generative | audio_classes:
        assert getattr(port, name) is getattr(port_image if name in generative else port_audio, name), name
        assert name in port.__all__ and name in jax_package.__all__, name
    for name in audio_functions:
        assert getattr(port_functional, name) is getattr(port_functional_audio, name), name
        assert (name in port_functional.__all__) == (name in jax_package.functional.__all__), name
    assert sum(name in port_functional.__all__ for name in audio_functions) == 6


def test_every_text_name_is_ported_but_the_encoder_backed(jax_package):
    """Every text name, the encoder-backed ones included since they were ported: the 16 text classes of
    ``text/metrics.py`` at the top level and in ``text``; the 16 text entries, 13 of them in the port's
    ``functional.__all__`` as in JAX's, and ``edit_distance``, ``bert_score`` and ``infolm`` attributes only."""
    import torchmetrics_tpu.functional as jf
    import torchmetrics_tpu.functional.text as jft
    import torchmetrics_tpu.text as jtext

    classes = set(jtext.__all__)
    assert len(classes) == 16 and sorted(classes) == sorted(port_text.__all__)
    for name in classes:
        assert getattr(port, name) is getattr(port_text, name) and name in port.__all__, name
    entries = _public(jft, inspect.isfunction)
    assert len(entries) == 16 and {"bert_score", "infolm"} <= entries
    for name in entries:
        assert callable(getattr(port_functional, name)), name
        assert (name in port_functional.__all__) == (name in jf.__all__), name
    assert sum(name in port_functional.__all__ for name in entries) == 13
    assert not {"edit_distance", "bert_score", "infolm"} & set(port_functional.__all__)
    assert port_functional.bert_score is port.functional.text.bert_score


def test_every_multimodal_and_detection_name_is_ported(jax_package):
    """The 2 multimodal and 7 detection classes in their modules and at the top level; the 2 multimodal and 6
    detection entries in their modules and as attributes of ``functional``, where ``functional.__all__``
    lists only ``panoptic_quality``, as JAX's does."""
    import torchmetrics_tpu.detection as jd
    import torchmetrics_tpu.functional as jf
    import torchmetrics_tpu.functional.detection as jfd
    import torchmetrics_tpu.functional.multimodal as jfm
    import torchmetrics_tpu.multimodal as jm

    for theirs, ours, n in ((jm, port_multimodal, 2), (jd, port_detection, 7)):
        assert len(theirs.__all__) == n and sorted(theirs.__all__) == sorted(ours.__all__)
        for name in theirs.__all__:
            assert getattr(port, name) is getattr(ours, name) and name in port.__all__, name
    for theirs, ours, n in ((jfm, port_functional_multimodal, 2), (jfd, port_functional_detection, 6)):
        assert len(theirs.__all__) == n and sorted(theirs.__all__) == sorted(ours.__all__)
        for name in theirs.__all__:
            assert getattr(port_functional, name) is getattr(ours, name), name
            assert (name in port_functional.__all__) == (name in jf.__all__), name
    assert [n for n in port_functional.__all__ if n in jfd.__all__ + jfm.__all__] == ["panoptic_quality"]


def test_top_level_exports_every_ported_name(jax_package):
    """The repair of the top-level exports: ``from torchmetrics_tpu_torch import Accuracy`` works for
    every ported class that ``torchmetrics_tpu.__all__`` lists."""
    wanted = _ported(jax_package, set(jax_package.__all__) - NOT_METRICS)
    assert {"Accuracy", "ConfusionMatrix", "SumMetric", "RunningMean", "CohenKappa", "Dice", "RetrievalMAP",
            "R2Score", "KendallRankCorrCoef", "BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric",
            "MultioutputWrapper", "MultitaskWrapper"} <= wanted
    assert sorted(wanted - set(port.__all__)) == []
    for name in wanted:
        assert getattr(port, name).__name__ == name


def test_functional_exports_every_ported_name(jax_package):
    import torchmetrics_tpu.functional as jf

    wanted = _ported(jf, set(jf.__all__))
    assert sorted(wanted - set(port_functional.__all__)) == []
    for name in wanted:
        assert callable(getattr(port_functional, name)), name


def test_coverage_meter(jax_package, capsys):
    """How many names of each ``__all__`` the port still lacks (the rest of queue A of the roadmap)."""
    import torchmetrics_tpu.functional as jf
    import torchmetrics_tpu.utils as jax_utils

    import torchmetrics_tpu_torch.utils as port_utils

    lines, ported = [], {}
    for label, theirs, ours, skip in (
            ("torchmetrics_tpu.__all__", jax_package.__all__, port.__all__, NOT_METRICS),
            ("torchmetrics_tpu.functional.__all__", jf.__all__, port_functional.__all__, NOT_METRICS),
            ("torchmetrics_tpu.utils.__all__", jax_utils.__all__, port_utils.__all__, set())):
        names = set(theirs) - skip
        missing = names - set(ours)
        ported[label] = (len(names) - len(missing), len(names))
        lines.append(f"{label}: {len(names) - len(missing)} of {len(names)} names ported, {len(missing)} to go")
    with capsys.disabled():
        print("\n" + "\n".join(lines))
    assert all("names ported" in line for line in lines)
    assert ported["torchmetrics_tpu.__all__"] == (150, 150)  # after the serving tier's three names
    assert ported["torchmetrics_tpu.functional.__all__"] == (95, 95)  # after panoptic_quality
    assert ported["torchmetrics_tpu.utils.__all__"] == (23, 23)  # after C6
    assert all(getattr(port_utils, n) is not None for n in port_utils.__all__)


def test_robust_is_exported_with_jax_s_names_less_chaos(jax_package):
    """``robust`` is a top-level module of the port, as of the JAX package; its ``__all__`` is JAX's less
    ``chaos``: the fault-injection harness has its serving part and its core (the sync and graph-tier injectors,
    ``ChaosRunner``, ``SimWorld`` and the scenarios that need neither the codecs nor the shard), while
    ``ChaosMatrix`` and the export wait for them (ROADMAP.md, queue A, items 9b and 9c). Every name resolves."""
    import torchmetrics_tpu.robust as jax_robust
    import torchmetrics_tpu.robust.chaos as jax_chaos

    import torchmetrics_tpu_torch.robust as robust
    import torchmetrics_tpu_torch.robust.chaos as chaos

    assert "robust" in port.__all__ and port.robust is robust
    assert sorted(robust.__all__) == sorted(set(jax_robust.__all__) - {"chaos"})
    for name in robust.__all__:
        assert getattr(robust, name) is not None, name
    ported = {"counters", "Injector", "StagingTransferFailure", "DrainThreadDeath", "QueueOverflow",
              "PreemptMidOverlap", "AotCompileFailure", "DonationHazard", "CollectiveTimeout", "NaNPoison",
              "ChaosRunner", "SimWorld", "ENV_CHAOS_SEED", "DEFAULT_SEED"}
    assert all(hasattr(jax_chaos, n) and hasattr(chaos, n) for n in ported)
    scenarios = {n[len("scenario_"):] for n in dir(jax_chaos) if n.startswith("scenario_")}
    waiting = {"sharded_preemption_restore", "compressed_sync_quorum", "schedule_race_sweep"}
    assert sorted(chaos.SCENARIOS) == sorted(scenarios - waiting)
    assert all(getattr(chaos, f"scenario_{n}") is chaos.SCENARIOS[n] for n in chaos.SCENARIOS)
    assert not any(hasattr(chaos, n) for n in ("ChaosMatrix", *(f"scenario_{w}" for w in waiting)))


def test_serve_and_obs_are_exported_with_jax_s_names(jax_package):
    """``serve`` carries the JAX package's ``__all__`` name for name; ``IngestEngine``, ``IngestTicket`` and
    ``ServeOptions`` are top-level names; ``obs`` exports ``trace``, ``bundle`` and the bundle entry points under
    JAX's names, and nothing JAX's ``obs`` lacks."""
    import torchmetrics_tpu.obs as jax_obs
    import torchmetrics_tpu.serve as jax_serve

    import torchmetrics_tpu_torch.obs as obs
    import torchmetrics_tpu_torch.serve as serve

    assert serve.__all__ == jax_serve.__all__
    for name in serve.__all__:
        assert getattr(serve, name) is not None, name
    for name in ("IngestEngine", "IngestTicket", "ServeOptions"):
        assert name in port.__all__ and getattr(port, name) is getattr(serve, name)
    assert {"trace", "bundle", "capture_bundle", "last_bundle_path", "merge_fleet_bundles",
            "validate_bundle"} <= set(obs.__all__)
    assert set(obs.__all__) <= set(jax_obs.__all__)
    assert obs.bundle.BUNDLE_MAGIC == jax_obs.bundle.BUNDLE_MAGIC and obs.bundle.FORMAT == jax_obs.bundle.FORMAT
    assert obs.bundle.REQUIRED_SECTIONS == jax_obs.bundle.REQUIRED_SECTIONS
