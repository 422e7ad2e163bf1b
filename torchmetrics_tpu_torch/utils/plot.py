"""Plotting helpers, matplotlib optional (counterpart of ``torchmetrics_tpu/utils/plot.py``; reference
``src/torchmetrics/utilities/plot.py``: ``plot_single_or_multi_val:62``, ``plot_confusion_matrix:199``,
``plot_curve:268``).

Values are drawn on the host: every tensor goes to numpy through ``.detach().cpu()`` first, so a value on
the card draws as one on the CPU does.
"""
from __future__ import annotations

import importlib.util
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
from torch import Tensor

#: whether matplotlib can be imported here (the port's own probe; the machine with the card has none)
_MATPLOTLIB_AVAILABLE = importlib.util.find_spec("matplotlib") is not None

if _MATPLOTLIB_AVAILABLE:
    import matplotlib.pyplot as plt

    style_change = plt.style.context  # reference ``plot.py:32``: themeable plot context
else:
    from contextlib import contextmanager

    @contextmanager
    def style_change(*args: Any, **kwargs: Any):
        """No-op stand-in when matplotlib is absent (``plot.py:29``)."""
        yield


def _error_on_missing_matplotlib() -> None:
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(
            "Plot function expects `matplotlib` to be installed. Install with `pip install matplotlib`."
        )


def _np(x: Any) -> np.ndarray:
    """A value as a host numpy array: a tensor through ``.detach().cpu()``, a sequence item by item."""
    if isinstance(x, Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return np.asarray([_np(e) for e in x])
    return np.asarray(x)


def _get_col_row_split(n: int) -> Tuple[int, int]:
    """Near-square (rows, cols) grid that fits ``n`` panels (reference ``plot.py:172``)."""
    nsq = np.sqrt(n)
    if nsq * nsq == n:
        return int(nsq), int(nsq)
    if np.floor(nsq) * np.ceil(nsq) >= n:
        return int(np.floor(nsq)), int(np.ceil(nsq))
    return int(np.ceil(nsq)), int(np.ceil(nsq))


def trim_axs(axs: Any, nb: int) -> Any:
    """Hide grid axes beyond the ``nb`` used panels; return the used ones (reference ``plot.py:182``)."""
    if isinstance(axs, np.ndarray):
        flat = axs.ravel()
        for ax in flat[nb:]:
            ax.set_visible(False)
        return flat[:nb]
    return axs


def plot_single_or_multi_val(
    val: Any,
    ax: Any = None,
    higher_is_better: Optional[bool] = None,
    name: Optional[str] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
) -> Any:
    """Plot a single value or a sequence of (possibly dict-valued) metric values (reference ``plot.py:62``)."""
    _error_on_missing_matplotlib()
    fig, ax = (ax.get_figure(), ax) if ax is not None else plt.subplots()
    if isinstance(val, dict):
        for i, (k, v) in enumerate(val.items()):
            ax.plot(i, _np(v), "o", label=k)
    elif isinstance(val, Sequence):
        n_steps = len(val)
        if isinstance(val[0], dict):
            val_dict = {k: [_np(v[k]) for v in val] for k in val[0]}
            for k, v in val_dict.items():
                ax.plot(range(n_steps), np.stack([np.atleast_1d(x) for x in v]), label=k)
        else:
            arr = np.stack([np.atleast_1d(_np(v)) for v in val])
            for c in range(arr.shape[1]):
                lbl = f"{legend_name or 'class'} {c}" if arr.shape[1] > 1 else None
                ax.plot(range(n_steps), arr[:, c], marker="o", label=lbl)
    else:
        arr = np.atleast_1d(_np(val))
        for c, v in enumerate(arr):
            lbl = f"{legend_name or 'class'} {c}" if arr.size > 1 else None
            ax.plot([0], [v], "o", label=lbl)
    if name is not None:
        ax.set_title(name)
    handles, labels = ax.get_legend_handles_labels()
    if labels:
        ax.legend()
    ax.grid(True)
    # metric bounds as dashed guides, with the optimal side annotated (reference plot.py:138-168)
    bounds = [b for b in (lower_bound, upper_bound) if b is not None]
    if bounds:
        ylim = ax.get_ylim()
        pad = 0.1 * ((upper_bound - lower_bound) if len(bounds) == 2 else (ylim[1] - ylim[0]))
        ax.set_ylim(
            bottom=(lower_bound - pad) if lower_bound is not None else ylim[0] - pad,
            top=(upper_bound + pad) if upper_bound is not None else ylim[1] + pad,
        )
        xlim = ax.get_xlim()
        ax.hlines(bounds, xlim[0], xlim[1], linestyles="dashed", colors="k")
        optimal = (
            upper_bound if (higher_is_better and upper_bound is not None)
            else lower_bound if (higher_is_better is False and lower_bound is not None)
            else None
        )
        if optimal is not None:
            ax.set_xlim(xlim[0] - 0.1 * (xlim[1] - xlim[0]), xlim[1])
            ax.text(xlim[0], optimal, s="Optimal \n value", ha="center", va="center")
    return fig, ax


def plot_confusion_matrix(
    confmat: Any,
    ax: Any = None,
    add_text: bool = True,
    labels: Optional[List[str]] = None,
    cmap: Optional[str] = None,
) -> Any:
    """Heatmap of a (C, C) (or (N, 2, 2) multilabel) confusion matrix (reference ``plot.py:199``)."""
    _error_on_missing_matplotlib()
    confmat = _np(confmat)
    if confmat.ndim == 3:  # multilabel
        nb, rows, cols = confmat.shape
    else:
        nb, rows, cols = 1, *confmat.shape
        confmat = confmat[None]
    if labels is not None and confmat.ndim != 3 and len(labels) != rows:
        raise ValueError("Expected number of elements in arg `labels` to match number of labels in confmat")
    labels = labels or np.arange(rows).tolist()
    if ax is None:
        grid_rows, grid_cols = _get_col_row_split(nb)
        fig, axs = plt.subplots(nrows=grid_rows, ncols=grid_cols)
        axs = trim_axs(axs, nb)
    else:
        fig, axs = ax.get_figure(), ax
    axs_list = np.atleast_1d(np.asarray(axs, dtype=object)).ravel().tolist()
    for i in range(nb):
        ax_i = axs_list[i] if i < len(axs_list) else axs_list[0]
        im = ax_i.imshow(confmat[i], cmap=cmap)
        ax_i.set_xlabel("Predicted class")
        ax_i.set_ylabel("True class")
        ax_i.set_xticks(range(cols))
        ax_i.set_yticks(range(rows))
        ax_i.set_xticklabels(labels, rotation=45)
        ax_i.set_yticklabels(labels)
        if add_text:
            for ii in range(rows):
                for jj in range(cols):
                    ax_i.text(jj, ii, str(round(float(confmat[i, ii, jj]), 2)), ha="center", va="center")
    fig.colorbar(im)
    return fig, axs


def plot_curve(
    curve: Tuple,
    score: Any = None,
    ax: Any = None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> Any:
    """Plot an (x, y, thresholds)-style curve (reference ``plot.py:268``)."""
    _error_on_missing_matplotlib()
    x, y = _np(curve[0]), _np(curve[1])
    fig, ax = (ax.get_figure(), ax) if ax is not None else plt.subplots()
    if y.ndim > 1:
        for i in range(y.shape[0]):
            lbl = f"{legend_name or 'class'} {i}"
            if score is not None and np.ndim(_np(score)) > 0:
                lbl += f" AUC={float(_np(score).ravel()[i]):0.3f}"
            ax.plot(x[i] if x.ndim > 1 else x, y[i], linestyle="-", linewidth=2, label=lbl)
    else:
        lbl = None
        if score is not None:
            lbl = f"AUC={float(_np(score)):0.3f}"
        ax.plot(x, y, linestyle="-", linewidth=2, label=lbl)
    if label_names is not None:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    if name is not None:
        ax.set_title(name)
    handles, labels = ax.get_legend_handles_labels()
    if labels:
        ax.legend()
    return fig, ax
