"""Host-side matplotlib figures: OSCR curves, confidence curves, histograms.

Counterpart of :mod:`openset_imagenet_tpu.plots`, the plotting helpers of
reference ``util.py:125-228`` and the figure layouts of
``script/plot_all.py:151-340``: OSCR grids (semilog/log/linear with the
same axis limits and tick policies), confidence curves read back from
the scalar record, and softmax histograms with the garbage
background-column drop.  This is the only module of the port that
imports matplotlib, and nothing on the card's path imports it.
"""

from __future__ import annotations

import numpy as np
import matplotlib
from matplotlib import colors as mcolors, pyplot, ticker

from .ops.oscr import calculate_oscr

TAB10 = matplotlib.colormaps["tab10"].colors


def _legend_ax(axs, preferred_index: int):
    """Legend host axis; clamps for small grids (1x1 single-run reports
    would index out of bounds — a latent reference crash, plot_all.py:260)."""
    return axs[preferred_index] if len(axs) >= -preferred_index else axs[-1]


def style_oscr_axis(ax, scale: str):
    """Axis scales/limits/ticks per reference ``util.py:129-155``."""
    if scale == "log":
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_ylim(0.09, 1)
        ax.set_xlim(8e-5, 1.4)
        ax.xaxis.set_major_locator(ticker.LogLocator(base=10, numticks=100))
        minor = ticker.LogLocator(base=10.0,
                                  subs=np.linspace(0, 1, 10, False),
                                  numticks=12)
        ax.xaxis.set_minor_locator(minor)
        ax.xaxis.set_minor_formatter(ticker.NullFormatter())
    elif scale == "semilog":
        ax.set_xscale("log")
        ax.set_ylim(0.0, 0.8)
        ax.set_xlim(8e-5, 1.4)
        ax.yaxis.set_major_locator(ticker.MultipleLocator(0.2))
        ax.xaxis.set_major_locator(ticker.LogLocator(base=10, numticks=10))
        minor = ticker.LogLocator(base=10.0,
                                  subs=np.linspace(0, 1, 10, False),
                                  numticks=12)
        ax.xaxis.set_minor_locator(minor)
        ax.xaxis.set_minor_formatter(ticker.NullFormatter())
    else:
        ax.set_ylim(0.0, 0.8)
        ax.yaxis.set_major_locator(ticker.MultipleLocator(0.2))


def plot_single_oscr(x, y, ax, exp_name, color, baseline=False,
                     scale="linear"):
    """One OSCR curve on a styled axis (reference ``util.py:125-167``)."""
    style_oscr_axis(ax, scale)
    x = np.asarray(x)
    y = np.asarray(y)
    if x.size:  # drop fpr == 0 (log-scale artifact, reference util.py:157)
        keep = x != 0
        x, y = x[keep], y[keep]
    ax.plot(x, y, label=exp_name, color=color, linewidth=1,
            linestyle="dashed" if baseline else "solid")
    return ax


def plot_oscr(arrays, methods, scale="linear", title=None, ax_label_font=13,
              ax=None, unk_label=-1):
    """OSCR curves for several score archives on one axis.

    Parity: reference ``util.py:170-199`` — garbage archives drop the
    background column before OSCR; missing archives plot as empty curves.
    """
    assert len(arrays) == len(methods)
    if ax is None:
        ax = pyplot.gca()
    for idx, array in enumerate(arrays):
        if array is None:
            ccr, fpr = [], []
        else:
            scores = array["scores"]
            if methods[idx] == "garbage":
                scores = scores[:, :-1]
            ccr, fpr = calculate_oscr(array["gt"], scores, unk_label)
        plot_single_oscr(fpr, ccr, ax=ax, exp_name=methods[idx],
                         color=TAB10[idx], scale=scale)
    if title is not None:
        ax.set_title(title, fontsize=ax_label_font)
    ax.tick_params(which="both", bottom=True, top=True, left=True,
                   right=True, direction="in")
    ax.tick_params(labelbottom=True, labeltop=False, labelleft=True,
                   labelright=False, labelsize=ax_label_font)
    return ax


def oscr_figure(scores, protocols, loss_functions, labels, scale="semilog",
                sort_by_loss=False):
    """2 x N grid of OSCR plots: negatives (top) / unknowns (bottom).

    Parity: reference ``script/plot_all.py:151-190``.
    """
    n_cols = len(loss_functions) if sort_by_loss else len(protocols)
    fig = pyplot.figure(figsize=(5 * n_cols, 6))
    gs = fig.add_gridspec(2, n_cols, hspace=0.2, wspace=0.05)
    axs = np.atleast_1d(gs.subplots(sharex=True, sharey=True)).flatten()
    font = 15

    if sort_by_loss:
        for i, loss in enumerate(loss_functions):
            test = [scores[p][loss]["test"] if scores[p][loss] is not None
                    else None for p in protocols]
            methods = [loss] * len(protocols)
            plot_oscr(test, methods, scale, f"{labels[i]} Negative",
                      font, axs[i], unk_label=-1)
            plot_oscr(test, methods, scale, f"{labels[i]} Unknown",
                      font, axs[i + n_cols], unk_label=-2)
        legend = [f"$P_{p}$" for p in protocols]
    else:
        for i, p in enumerate(protocols):
            test = [scores[p][l]["test"] if scores[p][l] is not None
                    else None for l in loss_functions]
            plot_oscr(test, list(loss_functions), scale, f"$P_{p}$ Negative",
                      font, axs[i], unk_label=-1)
            plot_oscr(test, list(loss_functions), scale, f"$P_{p}$ Unknown",
                      font, axs[i + n_cols], unk_label=-2)
        legend = list(labels)

    _legend_ax(axs, -n_cols).legend(
        legend, frameon=False, fontsize=font - 1,
        bbox_to_anchor=(0.8, -0.12), ncol=3,
        handletextpad=0.5, columnspacing=1, markerscale=3)
    for ax in axs:
        ax.label_outer()
        ax.grid(axis="x", linestyle=":", linewidth=1, color="gainsboro")
        ax.grid(axis="y", linestyle=":", linewidth=1, color="gainsboro")
    fig.text(0.5, 0.03, "FPR", ha="center", fontsize=font)
    fig.text(0.08, 0.5, "CCR", va="center", rotation="vertical",
             fontsize=font)
    return fig


def confidence_figure(curves, protocols, loss_functions, labels):
    """Confidence-vs-epoch curves from the per-run scalar records.

    Parity: reference ``script/plot_all.py:193-273``; the data source is
    ``{protocol: {loss: {tag: [(step, value)...]}}}`` as produced by
    :func:`openset_imagenet_tpu_torch.events.read_scalars` (tensorboard events or
    the CSV sidecar).  Epochs are plotted 1-based like the reference.
    """
    n_p = len(protocols)
    font = 15
    fig = pyplot.figure(figsize=(12, 3 * n_p + 1))
    gs = fig.add_gridspec(n_p, 2, hspace=0.2, wspace=0.1)
    axs = np.atleast_1d(gs.subplots(sharex=True, sharey=True)).flatten()

    lo, hi = 100, 0
    for i, protocol in enumerate(protocols):
        ax_kn, ax_unk = axs[2 * i], axs[2 * i + 1]
        for c, loss in enumerate(loss_functions):
            tags = curves.get(protocol, {}).get(loss, {})
            kn = tags.get("val/conf_kn", [])
            unk = tags.get("val/conf_unk", [])
            step_kn = [s + 1 for s, _ in kn]
            step_unk = [s + 1 for s, _ in unk]
            ax_kn.plot(step_kn, [v for _, v in kn], linewidth=1.5,
                       label=loss + " kn", color=TAB10[c])
            ax_unk.plot(step_unk, [v for _, v in unk], linewidth=1.5,
                        label=loss + " unk", color=TAB10[c])
            if step_kn:
                hi = max(hi, max(step_kn))
                lo = min(lo, min(step_kn))
        ax_kn.set_title(f"$P_{protocol}$ Known", fontsize=font)
        ax_unk.set_title(f"$P_{protocol}$ Negative", fontsize=font)

    _legend_ax(axs, -2).legend(
        labels, frameon=False, fontsize=font - 1,
        bbox_to_anchor=(0.8, -0.1), ncol=3, handletextpad=0.5,
        columnspacing=1)
    for ax in axs:
        ax.tick_params(which="both", bottom=True, top=True, left=True,
                       right=True, direction="in")
        ax.tick_params(labelbottom=True, labeltop=False, labelleft=True,
                       labelright=False, labelsize=font)
        if hi > lo:
            ax.set_xlim(lo, hi)
        ax.set_ylim(0, 1)
        ax.yaxis.set_major_locator(ticker.MaxNLocator(5, prune="lower"))
        ax.xaxis.set_major_locator(ticker.MaxNLocator(6))
        ax.label_outer()
    fig.text(0.5, 0.05, "Epoch", ha="center", fontsize=font)
    return fig


def softmax_figure(scores, protocols, loss_functions, labels, bins=30,
                   unk_label=-2):
    """Known-vs-unknown softmax histograms (reference plot_all.py:277-340)."""
    from .util import get_histogram

    font = 15
    n_p, n_l = len(protocols), len(loss_functions)
    fig = pyplot.figure(figsize=(3 * n_p + 1, 2 * n_l))
    gs = fig.add_gridspec(n_l, n_p, hspace=0.2, wspace=0.08)
    axs = np.atleast_1d(gs.subplots(sharex=True, sharey=False)).flatten()

    edge_unk = mcolors.to_rgba("indianred", 1)
    fill_unk = mcolors.to_rgba("firebrick", 0.04)
    edge_kn = mcolors.to_rgba("tab:blue", 1)
    fill_kn = mcolors.to_rgba("tab:blue", 0.04)

    # Panel order is protocol-outer over a (losses x protocols)
    # gridspec — for len(protocols) != len(loss_functions) the panels do
    # not align with grid rows/columns.  This reproduces the reference's
    # own layout (plot_all.py:295-317) exactly, including that quirk;
    # every panel is individually titled either way.
    idx = 0
    for protocol in protocols:
        for l, loss in enumerate(loss_functions):
            if scores[protocol][loss] is not None:
                kn_hist, kn_edges, unk_hist, unk_edges = get_histogram(
                    scores[protocol][loss]["test"], unk_label=unk_label,
                    metric="score", bins=bins,
                    drop_bg=(loss == "garbage"))
            else:
                kn_hist, kn_edges, unk_hist, unk_edges = [], [0], [], [0]
            axs[idx].stairs(kn_hist, kn_edges, fill=True, color=fill_kn,
                            edgecolor=edge_kn, linewidth=1)
            axs[idx].stairs(unk_hist, unk_edges, fill=True, color=fill_unk,
                            edgecolor=edge_unk, linewidth=1)
            axs[idx].set_title(f"$P_{{{protocol}}}$ {labels[l]}")
            idx += 1

    for p in range(n_p):
        for l in range(1, n_l):
            axs[n_l * p + l - 1].sharey(axs[n_l * p + l])
    for ax in axs:
        ax.tick_params(which="both", bottom=True, top=True, left=True,
                       right=True, direction="in")
        ax.tick_params(labelbottom=True, labeltop=False, labelleft=True,
                       labelright=False, labelsize=font)
        ax.yaxis.set_major_locator(ticker.MaxNLocator(6))
        ax.label_outer()
    _legend_ax(axs, -2).legend(
        ["Known", "Unknown"], frameon=False, fontsize=font - 1,
        bbox_to_anchor=(0.2, -0.08), ncol=2, handletextpad=0.3,
        columnspacing=1, markerscale=1)
    fig.text(0.5, 0.02, "Score", ha="center", fontsize=font)
    return fig
