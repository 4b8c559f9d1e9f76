"""The results report (PDF figures + LaTeX table): the port's
``plot_imagenet``.

    python -m openset_imagenet_tpu_torch.script.plot_all -o experiments

Counterpart of the JAX CLI (``script/plot_all.py``, reference
``script/plot_all.py:22-425``), with its flags, its page set (the OSCR
grid always; the confidence and histogram pages and the CCR/confidence
LaTeX table only in the default, non-linear, non-by-loss mode) and its
output names ``Results_{last,best,linear}[_by_loss].pdf/.tex``.  Missing
(or, with ``--force``, all) score archives are produced by a child
``python -m openset_imagenet_tpu_torch.script.evaluate``, given ``-g``,
``--device`` and ``--reader`` (the default is the card); the epochs come
from the checkpoints' metadata and the confidence curves from the
training scalar record (:func:`~..events.read_scalars`).  matplotlib is
imported by the figures only: ``load_scores`` and ``conf_and_ccr_table``
run without it.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys

import numpy as np


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        "plot_imagenet_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--protocols", type=int, choices=(1, 2, 3),
                        nargs="+", default=(1, 2, 3),
                        help="Protocols to evaluate")
    parser.add_argument("--loss-functions", "-l", nargs="+",
                        choices=("softmax", "garbage", "entropic"),
                        default=("softmax", "garbage", "entropic"),
                        help="Loss functions to evaluate")
    parser.add_argument("--labels", nargs="+",
                        choices=("S", "BG", "EOS"),
                        default=("S", "BG", "EOS"),
                        help="Plot labels for the losses")
    parser.add_argument("--use-best", action="store_true",
                        help="Use the best model by validation score "
                             "instead of the last")
    parser.add_argument("--force", "-f", action="store_true",
                        help="Recompute score files even if they exist")
    parser.add_argument("--linear", action="store_true",
                        help="Plot OSCR curves with a linear FPR axis")
    parser.add_argument("--sort-by-loss", "-s", action="store_true",
                        help="Compare across protocols instead of losses")
    parser.add_argument("--output-directory", "-o", type=pathlib.Path,
                        default="experiments",
                        help="Directory where the models are saved")
    parser.add_argument("--imagenet-directory", type=pathlib.Path,
                        default=pathlib.Path(
                            "/local/scratch/datasets/ImageNet/ILSVRC2012/"),
                        help="ImageNet root directory")
    parser.add_argument("--protocol-directory", type=pathlib.Path,
                        default="protocols",
                        help="Where the protocol files are stored")
    parser.add_argument("--gpu", "-g", type=int, nargs="?", default=None,
                        const=0, help="Extract scores on this CUDA device "
                                      "index")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Extract scores on the card (default) or on "
                             "the host")
    parser.add_argument("--reader", default="auto",
                        choices=("auto", "native", "pil", "synthetic"),
                        help="Image reader of the child evaluate (not a "
                             "flag of the JAX plot_all): 'synthetic' drives "
                             "the extraction on a host without libjpeg, "
                             "PIL or the images, as the GPU smoke run does")
    parser.add_argument("--plots", help="Output PDF path override")
    parser.add_argument("--table", help="Output LaTeX table path override")
    args = parser.parse_args(argv)

    suffix = "linear" if args.linear else "best" if args.use_best else "last"
    if args.sort_by_loss:
        suffix += "_by_loss"
    args.plots = args.plots or f"Results_{suffix}.pdf"
    args.table = args.table or f"Results_{suffix}.tex"
    return args


def load_scores(args):
    """Score archives + (epoch, best score) per (protocol, loss).

    Missing/forced ``.npz`` archives are produced by the evaluate CLI
    (reference ``script/plot_all.py:116-148``).
    """
    from ..checkpoint import read_metadata
    from ..util import read_array_list

    scores = {p: {} for p in args.protocols}
    epoch = {p: {} for p in args.protocols}
    suffix = "_best" if args.use_best else "_curr"
    for protocol in args.protocols:
        for loss in args.loss_functions:
            experiment_dir = args.output_directory / f"Protocol_{protocol}"
            checkpoint_file = experiment_dir / f"{loss}{suffix}.pth"
            score_files = {
                v: experiment_dir / f"{loss}_{v}_arr{suffix}.npz"
                for v in ("val", "test")}
            if os.path.exists(checkpoint_file):
                if args.force or not all(os.path.exists(v)
                                         for v in score_files.values()):
                    print("Extracting scores of", checkpoint_file)
                    call = [sys.executable, "-m",
                            "openset_imagenet_tpu_torch.script.evaluate",
                            loss, str(protocol),
                            "--output-directory", str(experiment_dir),
                            "--imagenet-directory",
                            str(args.imagenet_directory),
                            "--protocol-directory",
                            str(args.protocol_directory),
                            "--device", args.device,
                            "--reader", args.reader]
                    if args.gpu is not None:
                        call += ["-g", str(args.gpu)]
                    if args.use_best:
                        call += ["-b"]
                    rc = subprocess.call(call)
                    if rc != 0:
                        raise RuntimeError(
                            "score extraction failed (exit code "
                            f"{rc}): {' '.join(call)}")
                scores[protocol][loss] = read_array_list(score_files)
                meta = read_metadata(checkpoint_file)
                epoch[protocol][loss] = (meta["epoch"], meta["best_score"])
            else:
                print("Checkpoint file", checkpoint_file,
                      "not found, skipping protocol", protocol, loss)
                scores[protocol][loss] = None
                epoch[protocol][loss] = (0, 0)
    return scores, epoch


def load_confidence_curves(args):
    """{protocol: {loss: {tag: [(step, value)...]}}} from scalar records."""
    from ..events import read_scalars

    curves = {}
    for protocol in args.protocols:
        protocol_dir = args.output_directory / f"Protocol_{protocol}"
        curves[protocol] = {}
        for loss in args.loss_functions:
            # Per-run records carry the "-{loss}.log" writer suffix
            # (reference train.py:408 / script/plot_all.py:196-206).
            curves[protocol][loss] = (
                read_scalars(protocol_dir, suffix_filter=f"-{loss}.log")
                if protocol_dir.exists() else {})
    return curves


def conf_and_ccr_table(args, scores, epochs):
    """LaTeX table of test-set γ confidences + CCR@FPR (plot_all.py:344)."""
    from ..ops.metrics import confidence
    from ..ops.oscr import calculate_oscr, ccr_at_fpr

    query = [1e-3, 1e-2, 0.1, 1.0]
    with open(args.table, "w") as table:
        for p, protocol in enumerate(args.protocols):
            for l, loss in enumerate(args.loss_functions):
                if scores[protocol][loss] is None:  # checkpoint missing
                    table.write(f"$P_{protocol}$ - {args.labels[l]} & --- "
                                "& --- & --- & --- & --- & --- & ---\\\\\n")
                    continue
                array = scores[protocol][loss]["test"]
                gt = array["gt"].astype(int)
                values = array["scores"]
                ccr_, fpr_ = calculate_oscr(gt, values, unk_label=-2)
                offset = 0.0 if loss == "garbage" else 1 / (np.max(gt) + 1)
                last_valid = -1 if loss == "garbage" else None
                kn_conf, _, neg_conf, _ = confidence(
                    values, gt, offset=offset, unknown_class=-2,
                    last_valid_class=last_valid)
                table.write(f"$P_{protocol}$ - {args.labels[l]} & "
                            f"{epochs[protocol][loss][0]} & "
                            f"{kn_conf:1.3f} & {neg_conf:1.3f}")
                for q in query:
                    value = ccr_at_fpr(ccr_, fpr_, q)
                    table.write(" & ---" if value is None
                                else f" & {value:1.3f}")
                table.write("\\\\\n")
            if p < len(args.protocols) - 1:
                table.write("\\midrule\n")


def plot_OSCR(args, scores):
    """Reference-name adapter (reference plot_all.py:151): the figure
    itself lives in :func:`..plots.oscr_figure`."""
    from ..plots import oscr_figure
    return oscr_figure(scores, args.protocols, args.loss_functions,
                       args.labels,
                       scale="linear" if args.linear else "semilog",
                       sort_by_loss=args.sort_by_loss)


def plot_confidences(args):
    """Reference-name adapter (reference plot_all.py:193): loads the
    per-epoch confidence curves back from the training scalar records
    and renders :func:`..plots.confidence_figure`."""
    from ..plots import confidence_figure
    return confidence_figure(load_confidence_curves(args), args.protocols,
                             args.loss_functions, args.labels)


def plot_softmax(args, scores):
    """Reference-name adapter (reference plot_all.py:277)."""
    from ..plots import softmax_figure
    return softmax_figure(scores, args.protocols, args.loss_functions,
                          args.labels)


def main(argv=None):
    args = get_args(argv)
    from matplotlib.backends.backend_pdf import PdfPages

    print("Extracting and loading scores")
    scores, epoch = load_scores(args)

    print("Writing file", args.plots)
    pdf = PdfPages(args.plots)
    try:
        print("Plotting OSCR curves")
        pdf.savefig(plot_OSCR(args, scores), bbox_inches="tight",
                    pad_inches=0)

        if not args.linear and not args.use_best and not args.sort_by_loss:
            print("Plotting confidence plots")
            pdf.savefig(plot_confidences(args), bbox_inches="tight",
                        pad_inches=0)

        if not args.linear and not args.sort_by_loss:
            print("Plotting softmax histograms")
            pdf.savefig(plot_softmax(args, scores), bbox_inches="tight",
                        pad_inches=0)
    finally:
        pdf.close()

    if not args.linear and not args.sort_by_loss:
        print("Creating Table")
        print("Writing file", args.table)
        conf_and_ccr_table(args, scores, epoch)


if __name__ == "__main__":
    main()
