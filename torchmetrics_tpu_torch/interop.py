"""Carry metric state from the JAX package into the port.

The state a metric has accumulated is what the port carries across, as weights are for a model.
:func:`load_numpy_state` takes it as numpy arrays (``np.asarray`` of the JAX metric's
``metric_state``, ``torchmetrics_tpu/metric.py:269``), so this module never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers import BootStrapper, ClasswiseWrapper, MinMaxMetric, MultioutputWrapper

#: each wrapper's wrapped metrics, by the JAX package's attribute names: one metric or a list of copies
_WRAPPED = {BootStrapper: "metrics", MultioutputWrapper: "metrics", ClasswiseWrapper: "metric",
            MinMaxMetric: "_base_metric"}


def load_numpy_state(
    metric_or_collection: Union[Metric, MetricCollection], arrays: Dict[str, Any]
) -> Union[Metric, MetricCollection]:
    """Load accumulated states into a port metric or collection, on its device.

    For a metric, ``arrays`` maps state names to numpy arrays (a list of arrays for a list
    state). For a collection, it maps member names to such dicts. Each state keeps the dtype of
    the port's default: the JAX package's int32 confusion matrices (those of the Jaccard index,
    Cohen's kappa and MCC too) and float32 tp/fp/tn/fn counts (list states of ``samplewise``, and
    specificity's and Hamming distance's, included) become int64, after a check that the float
    values are whole. The float32 states stay float32: curve confmats, sketches, calibration bins,
    the fairness ``stats``, hinge ``measures``/``total``, ranking ``measure``/``total``, Dice's
    and exact match's sums and ``cat`` list entries, and the regression states (the sums and
    moments, the ``cat`` entries of Spearman, Kendall and cosine similarity as lists, and Pearson's
    six running states in their shapes, a leading world axis of stacked replicas included, which
    the compute folds: a synced state), the clustering ``cat`` entries (labels, data) as lists in their
own dtypes, the nominal float32 ``confmat`` and Fleiss' ``cat`` counts, the sketches' float32 states (the
    KLL compactor, the histogram, retrieval's sketch-mode aggregates and count-min grid), a keyed
    metric's ``(num_keys, ...)`` tables under the template's state names, and the image-quality states
    (the float32 sums, PSNR's ``min_target``/``max_target``, PSNR-B's ``data_range``, the ``cat`` entries
    of images and per-image values as lists) with TV's int32 ``num_elements``, which becomes the port's
    int64 count, and the generative and audio states (FID's 14 compensated float32 sums and counts, KID's,
    MiFID's and IS's ``cat`` lists of features, LPIPS's and the audio classes' float32 sums and counts). The metric then counts as updated; a collection regroups on its next call, by the
    same state equality as after its first batch.

    A wrapper takes its wrapped metrics' states under the JAX package's attribute names:
    ``BootStrapper`` and ``MultioutputWrapper`` a list of state dicts under ``"metrics"``, one per
    copy; ``ClasswiseWrapper`` one dict under ``"metric"``; ``MinMaxMetric`` one under
    ``"_base_metric"``, and its running ``"min_val"`` and ``"max_val"``, which are plain attributes
    there and here (JAX ``wrappers/minmax.py:34-35``), not states.
    """
    if isinstance(metric_or_collection, MetricCollection):
        collection = metric_or_collection
        unknown = set(arrays) - set(collection._modules)
        if unknown:
            raise KeyError(f"No member named {sorted(unknown)} in the collection; members are {list(collection._modules)}")
        for name, states in arrays.items():
            load_numpy_state(collection._modules[name], states)
        collection._init_compute_groups()
        return collection
    metric = metric_or_collection
    wrapped = next((attr for cls, attr in _WRAPPED.items() if isinstance(metric, cls)), None)
    if wrapped is not None:
        return _load_wrapper(metric, wrapped, dict(arrays))
    metric._set_states(dict(arrays))
    metric._update_count = max(metric._update_count, 1)
    return metric


def _load_wrapper(wrapper: Metric, attr: str, arrays: Dict[str, Any]) -> Metric:
    inner = arrays.pop(attr, None)
    if inner is not None:
        targets = getattr(wrapper, attr)
        if isinstance(targets, list):
            if len(inner) != len(targets):
                raise ValueError(f"{type(wrapper).__name__} holds {len(targets)} copies; {len(inner)} states were given")
            for target, states in zip(targets, inner):
                load_numpy_state(target, states)
        else:
            load_numpy_state(targets, inner)
    if isinstance(wrapper, MinMaxMetric):
        for name in ("min_val", "max_val"):
            if name in arrays:
                value = torch.as_tensor(np.asarray(arrays.pop(name)), dtype=torch.float32, device=wrapper.device)
                setattr(wrapper, name, value)
    if arrays:
        raise KeyError(f"{type(wrapper).__name__} takes no state named {sorted(arrays)}")
    wrapper._update_called = True
    wrapper._update_count = max(wrapper._update_count, 1)
    return wrapper
