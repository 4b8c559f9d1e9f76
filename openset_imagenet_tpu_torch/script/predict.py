"""Classify images with a trained open-set model: the port's
``predict_imagenet``.

    python -m openset_imagenet_tpu_torch.script.predict ckpt.pth auto imgs/

Counterpart of the JAX CLI (``script/predict.py``): load a ``_best`` /
``_curr`` checkpoint once, classify files, directories (searched
recursively) or ``.csv`` / ``.txt`` listings, and write a predictions CSV
of ``path,prediction,score`` rows, rejected samples as class ``-1``.  The
JAX flags and rules, plus ``--device {cuda,cpu}`` (default the card;
``-g N`` runs on ``cuda:N``) and ``--reader`` (not a JAX flag: the decode
of the images, ``auto`` being the JAX policy; ``synthetic`` needs no
libjpeg, PIL or image files).  ``--optimize fold_bn`` serves the folded
graph, ``--optimize int8`` the int8 graph, calibrated on
``--calibration-images`` or, without them, on the first 256 inputs
(self-calibration, decoded once for both passes).  ``--devices`` (ROADMAP
Queue 1 item 8) raises ``NotImplementedError``; ``--compile-cache`` /
``--no-compile-cache`` are accepted and have no effect (there is no XLA
cache; Queue 1 item 5).
"""

from __future__ import annotations

import argparse
import csv
import pathlib
import sys

IMAGE_SUFFIXES = (".jpeg", ".jpg", ".png", ".bmp", ".webp")
READERS = ("auto", "native", "pil", "synthetic")


def _n_classes(value: str):
    """Positional n_classes: an int, or 'auto' (read from the
    checkpoint's logits head)."""
    if value == "auto":
        return None
    return int(value)


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        "predict_imagenet_torch",
        description="Classify images with a trained open-set model "
                    "(PyTorch port)")
    parser.add_argument("checkpoint",
                        help="Trained checkpoint (.pth, the reference "
                             "layout)")
    parser.add_argument("n_classes", type=_n_classes,
                        help="Logit dimensionality the model was trained "
                             "with (garbage models: known classes + 1 "
                             "background), or 'auto' to read it from the "
                             "checkpoint's logits head")
    parser.add_argument("images", nargs="+",
                        help="Image files, directories (searched "
                             "recursively), or .csv/.txt listings of "
                             "relative paths (protocol-CSV format works)")
    parser.add_argument("--imagenet-directory", default=".",
                        help="Root that listed/relative paths resolve "
                             "against")
    parser.add_argument("--threshold", "-t", type=float, default=None,
                        help="Rejection threshold; 0 disables rejection "
                             "(default 0)")
    parser.add_argument("--threshold-at-fpr", type=float, default=None,
                        metavar="FPR",
                        help="Calibrate the rejection threshold so at "
                             "most this fraction of the calibration "
                             "set's unknowns is accepted (needs "
                             "--calibrate); mutually exclusive with "
                             "--threshold")
    parser.add_argument("--calibrate", metavar="ARR_NPZ", default=None,
                        help="evaluate_imagenet output arrays "
                             "(<loss>_val_arr.npz: gt/features/scores) "
                             "whose negative/unknown rows calibrate "
                             "--threshold-at-fpr")
    parser.add_argument("--mode", choices=("softmax", "objectosphere"),
                        default=None,
                        help="Rejection rule: max-softmax or "
                             "||feature||*score (reference "
                             "metrics.py:45-62; default softmax)")
    parser.add_argument("--background", default=None,
                        action=argparse.BooleanOptionalAction,
                        help="Garbage-regime checkpoint: exclude the "
                             "background column from the class decision "
                             "(default off)")
    parser.add_argument("--model-variant", default=None,
                        help="Model architecture; default reads the "
                             "variant stored in the checkpoint "
                             "(resnet50 for checkpoints without "
                             "metadata, e.g. the reference's)")
    parser.add_argument("--image-size", type=int, default=None,
                        help="Crop size the model expects (default 224)")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--no-stream", action="store_true",
                        help="Serial chunk loop (decode, then forward) "
                             "instead of the default pipelined "
                             "predict_stream")
    parser.add_argument("--output", "-o", default="-",
                        help="Predictions CSV path ('-' = stdout)")
    parser.add_argument("--features-output", metavar="NPZ", default=None,
                        help="Also save deep features + full softmax "
                             "scores as an .npz (keys: paths, features, "
                             "scores; row order matches the predictions "
                             "CSV)")
    parser.add_argument("--reader", choices=READERS, default="auto",
                        help="Image decode (not a JAX flag): auto (the "
                             "native JPEG batch reader, else PIL), "
                             "native, pil, or synthetic (seeded noise per "
                             "path: no libjpeg, PIL or files needed)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Predict on the card (default) or on the host")
    parser.add_argument("--optimize", choices=("fold_bn", "int8"),
                        default=None,
                        help="Inference-graph optimization: fold_bn folds "
                             "every batch-norm into the preceding "
                             "convolution; int8 also quantizes the block "
                             "convs to symmetric int8 (small quantization "
                             "noise on the scores)")
    parser.add_argument("--calibration-images", nargs="+", metavar="SPEC",
                        default=None,
                        help="Activation-range calibration inputs for "
                             "--optimize int8 (files/directories/listings "
                             "like the positional images). Default: "
                             "self-calibrate on the first 256 prediction "
                             "inputs")
    parser.add_argument("--calibration-percentile", type=float,
                        default=None, metavar="PCT",
                        help="Clip each int8 activation scale to this "
                             "percentile of |activation| (e.g. 99.9) "
                             "instead of the abs-max")
    parser.add_argument("--gpu", "-g", type=int, nargs="?", default=None,
                        const=0, help="Run on this CUDA device index")
    parser.add_argument("--devices", "-d", type=int, default=None,
                        help="Data-parallel serving over N devices: not "
                             "ported yet (ROADMAP Queue 1 item 8)")
    parser.add_argument("--compile-cache", metavar="DIR", default=None,
                        help="Accepted for the JAX CLI's sake; no effect")
    parser.add_argument("--no-compile-cache", action="store_true",
                        help="Accepted for the JAX CLI's sake; no effect")
    args = parser.parse_args(argv)
    if args.no_compile_cache and args.compile_cache is not None:
        parser.error("--compile-cache and --no-compile-cache are "
                     "mutually exclusive")
    if args.gpu is not None and args.devices is not None:
        parser.error("--gpu pins one device; --devices shards over "
                     "several — pass at most one of them")
    if args.threshold_at_fpr is not None:
        if args.calibrate is None:
            parser.error("--threshold-at-fpr needs --calibrate "
                         "(an evaluate_imagenet arrays .npz)")
        if args.threshold is not None:
            parser.error("--threshold and --threshold-at-fpr are "
                         "mutually exclusive")
    elif args.calibrate is not None:
        parser.error("--calibrate does nothing without --threshold-at-fpr")
    if args.calibration_images is not None and args.optimize != "int8":
        parser.error("--calibration-images does nothing without "
                     "--optimize int8")
    if args.calibration_percentile is not None and args.optimize != "int8":
        parser.error("--calibration-percentile does nothing without "
                     "--optimize int8")
    return args


def check_ported(args, log) -> None:
    """Raise for the flags whose work is not ported; log the no-ops."""
    if args.devices is not None:
        raise NotImplementedError("--devices (data-parallel serving) is not "
                                  "ported yet (ROADMAP Queue 1 item 8)")
    if args.compile_cache is not None or args.no_compile_cache:
        log.info("--compile-cache / --no-compile-cache name an XLA compile "
                 "cache: they have no effect in the PyTorch port")


def device_of(args):
    """The torch device of ``--device`` and ``-g``."""
    if args.device == "cpu":
        return "cpu"
    return "cuda" if args.gpu is None else f"cuda:{args.gpu}"


def reader_of(args, image_size: int):
    """The reader of ``--reader`` (``auto``: None, the predictor's serving
    policy)."""
    if args.reader == "auto":
        return None
    from ..config import NameSpace
    from ..train import _make_reader

    return _make_reader(NameSpace({"data": {"reader": args.reader},
                                   "seed": 0}), crop=image_size)


def calibrate_threshold(arr_path, fpr_target: float, mode: str,
                        has_background: bool) -> float:
    """Alias of :func:`openset_imagenet_tpu_torch.inference.
    calibrate_threshold` (the JAX CLI's import path)."""
    from ..inference import calibrate_threshold as impl

    return impl(arr_path, fpr_target, mode, has_background)


def collect_paths(specs, root: pathlib.Path):
    """Expand files / directories / listing files into image paths.

    Every returned path exists: a typo'd listing entry fails here, before
    any output is written.
    """
    paths = []
    for spec in specs:
        p = pathlib.Path(spec)
        if not p.exists():
            p = root / spec
        if p.is_dir():
            found = sorted(q for q in p.rglob("*")
                           if q.suffix.lower() in IMAGE_SUFFIXES)
            paths.extend(str(q) for q in found)
        elif p.is_file() and p.suffix.lower() in (".csv", ".txt"):
            # csv.reader undoes the quoting our own writer emits, so a
            # predictions CSV (header row skipped) is a valid listing.
            with p.open(newline="") as f:
                rows = list(csv.reader(f))
            if rows and [c.strip() for c in rows[0][:3]] == [
                    "path", "prediction", "score"]:
                rows = rows[1:]
            for row in rows:
                rel = row[0].strip() if row else ""
                if not rel:
                    continue
                q = pathlib.Path(rel)
                if not q.is_absolute():
                    q = root / rel
                if not q.is_file():
                    raise FileNotFoundError(
                        f"listing {p}: no such image: {rel}")
                paths.append(str(q))
        elif p.is_file():
            paths.append(str(p))
        else:
            raise FileNotFoundError(f"no such image/directory/listing: "
                                    f"{spec}")
    return paths


def main(argv=None):
    args = get_args(argv)
    from ..inference import OpenSetPredictor
    from ..logger import configure_logger

    log = configure_logger()
    check_ported(args, log)
    paths = collect_paths(args.images, pathlib.Path(args.imagenet_directory))
    if not paths:
        log.warning("no images found")
    calibration = None
    if paths and args.optimize == "int8":
        if args.calibration_images is not None:
            calibration = collect_paths(
                args.calibration_images,
                pathlib.Path(args.imagenet_directory))
            if not calibration:
                log.error("--calibration-images matched no images")
                return 1
        else:
            # Self-calibration on the data being served.
            calibration = paths[:256]
        log.info(f"int8 calibration on {len(calibration)} images")
    predictor = None
    if paths:
        image_size = 224 if args.image_size is None else args.image_size
        predictor = OpenSetPredictor(
            args.checkpoint, n_classes=args.n_classes,
            variant=args.model_variant, image_size=image_size,
            threshold=args.threshold, mode=args.mode,
            has_background=args.background, optimize=args.optimize,
            calibration=calibration,
            calibration_percentile=args.calibration_percentile,
            device=device_of(args), reader=reader_of(args, image_size))
        if args.threshold_at_fpr is not None:
            # After construction: the measure of the resolved mode.
            predictor.threshold = calibrate_threshold(
                args.calibrate, args.threshold_at_fpr, predictor.mode,
                predictor.has_background)
            log.info(f"calibrated threshold {predictor.threshold:.6g} "
                     f"(FPR <= {args.threshold_at_fpr} on {args.calibrate})")

    # An empty match still writes the header; paths with commas are
    # quoted, so every row parses back to three fields.
    out = (sys.stdout if args.output == "-"
           else open(args.output, "w", encoding="utf-8", newline=""))
    try:
        writer = csv.writer(out, lineterminator="\n")
        writer.writerow(["path", "prediction", "score"])
        rejected = 0
        arrays = args.features_output is not None

        def serial():
            for i in range(0, len(paths), args.batch_size):
                chunk = paths[i:i + args.batch_size]
                yield (chunk, *predictor.predict(chunk,
                                                 return_arrays=arrays))

        stream = () if not paths else (
            serial() if args.no_stream
            else predictor.predict_stream(paths,
                                          batch_size=args.batch_size,
                                          return_arrays=arrays))
        feat_chunks, score_chunks = [], []
        for chunk, pred, score, *rest in stream:
            rejected += int((pred == -1).sum())
            for p, c, s in zip(chunk, pred, score):
                writer.writerow([p, int(c), f"{float(s):.6f}"])
            out.flush()  # long runs stay tail-able
            if arrays:
                feat_chunks.append(rest[0])
                score_chunks.append(rest[1])
    finally:
        if out is not sys.stdout:
            out.close()
    if args.features_output is not None:
        import numpy as np

        empty_f = np.zeros((0, 0), np.float32)
        np.savez(args.features_output,
                 paths=np.asarray(paths),
                 features=(np.concatenate(feat_chunks) if feat_chunks
                           else empty_f),
                 scores=(np.concatenate(score_chunks) if score_chunks
                         else empty_f))
        log.info(f"saved features/scores -> {args.features_output}")
    log.info(f"predicted {len(paths)} images "
             f"({rejected} rejected as unknown)"
             + (f" -> {args.output}" if args.output != "-" else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
