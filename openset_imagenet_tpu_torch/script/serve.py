"""Serve open-set predictions over HTTP: the port's ``serve_imagenet``.

    python -m openset_imagenet_tpu_torch.script.serve ckpt.pth auto --port 8000
    curl -s -X POST --data-binary @img.jpg localhost:8000/v1/predict

Counterpart of the JAX CLI (``script/serve.py``): load a trained
checkpoint once, run every batch bucket up to ``--max-batch`` once
(unless ``--no-warmup``), then serve with dynamic batching
(:mod:`openset_imagenet_tpu_torch.serve`) until SIGINT or SIGTERM, which
shut down cleanly with exit code 0.  The model and operating-point flags
are ``predict``'s, with ``--device {cuda,cpu}`` (default the card) and
``-g N``; ``--optimize fold_bn`` serves the folded graph, ``--optimize
int8`` the int8 graph calibrated on ``--calibration-images`` (required:
no inputs exist at start-up to calibrate on).  ``--devices`` (ROADMAP
Queue 1 item 8) raises ``NotImplementedError``; ``--compile-cache`` has no
effect.
"""

from __future__ import annotations

import argparse
import pathlib
import signal
import sys
import threading

from .predict import (_n_classes, calibrate_threshold, check_ported,
                      collect_paths, device_of)


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        "serve_imagenet_torch",
        description="Serve open-set predictions over HTTP (PyTorch port)")
    parser.add_argument("checkpoint",
                        help="Trained checkpoint (.pth, the reference "
                             "layout)")
    parser.add_argument("n_classes", type=_n_classes,
                        help="Logit dimensionality the model was trained "
                             "with, or 'auto' to read it from the "
                             "checkpoint's logits head")
    parser.add_argument("--host", default="127.0.0.1",
                        help="Bind address (default loopback; use "
                             "0.0.0.0 behind a real ingress only)")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=64,
                        help="Largest coalesced device batch")
    parser.add_argument("--batch-window-ms", type=float, default=2.0,
                        help="How long a lone request waits for "
                             "companions before dispatching (0 = never "
                             "wait; simultaneous arrivals still share a "
                             "forward)")
    parser.add_argument("--request-timeout", type=float, default=30.0,
                        metavar="SECONDS",
                        help="Bounded wait for a prediction; past it the "
                             "request fails 503 and /healthz reports the "
                             "device thread wedged (0 = wait forever; a "
                             "cold bucket's first forward gets a 600s "
                             "grace floor)")
    parser.add_argument("--no-warmup", action="store_true",
                        help="Skip running the batch buckets at start-up "
                             "(first requests then pay kernel selection "
                             "and allocation)")
    parser.add_argument("--threshold", "-t", type=float, default=None,
                        help="Rejection threshold; 0 disables rejection "
                             "(default 0)")
    parser.add_argument("--threshold-at-fpr", type=float, default=None,
                        metavar="FPR",
                        help="Calibrate the rejection threshold from "
                             "--calibrate arrays (predict semantics)")
    parser.add_argument("--calibrate", metavar="ARR_NPZ", default=None,
                        help="evaluate_imagenet arrays whose negative/"
                             "unknown rows calibrate --threshold-at-fpr")
    parser.add_argument("--mode", choices=("softmax", "objectosphere"),
                        default=None)
    parser.add_argument("--background", default=None,
                        action=argparse.BooleanOptionalAction,
                        help="Garbage-regime checkpoint: exclude the "
                             "background column from the class decision")
    parser.add_argument("--model-variant", default=None,
                        help="Model architecture; default reads the "
                             "variant stored in the checkpoint "
                             "(resnet50 for checkpoints without "
                             "metadata, e.g. the reference's)")
    parser.add_argument("--image-size", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Serve from the card (default) or the host")
    parser.add_argument("--optimize", choices=("fold_bn", "int8"),
                        default=None,
                        help="Inference-graph optimization: fold_bn folds "
                             "batch-norms into the convs; int8 also "
                             "quantizes the block convs (needs "
                             "--calibration-images)")
    parser.add_argument("--calibration-images", nargs="+", metavar="SPEC",
                        default=None,
                        help="Activation-range calibration inputs for "
                             "--optimize int8: image files, directories, "
                             "or listings, drawn from the serving "
                             "distribution")
    parser.add_argument("--calibration-percentile", type=float,
                        default=None, metavar="PCT",
                        help="Clip each int8 activation scale to this "
                             "percentile of |activation| (e.g. 99.9) "
                             "instead of the abs-max")
    parser.add_argument("--gpu", "-g", type=int, nargs="?", default=None,
                        const=0, help="Serve from this CUDA device index")
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
            parser.error("--threshold-at-fpr needs --calibrate")
        if args.threshold is not None:
            parser.error("--threshold and --threshold-at-fpr are "
                         "mutually exclusive")
    elif args.calibrate is not None:
        parser.error("--calibrate does nothing without --threshold-at-fpr")
    if args.optimize == "int8" and args.calibration_images is None:
        parser.error("--optimize int8 needs --calibration-images "
                     "(no prediction inputs exist at daemon startup to "
                     "self-calibrate on)")
    if args.calibration_images is not None and args.optimize != "int8":
        parser.error("--calibration-images does nothing without "
                     "--optimize int8")
    if args.calibration_percentile is not None and args.optimize != "int8":
        parser.error("--calibration-percentile does nothing without "
                     "--optimize int8")
    return args


def main(argv=None):
    args = get_args(argv)
    from ..inference import OpenSetPredictor
    from ..logger import configure_logger
    from ..serve import PredictionServer

    log = configure_logger()
    check_ported(args, log)
    calibration = None
    if args.optimize == "int8":
        calibration = collect_paths(args.calibration_images,
                                    pathlib.Path("."))
        if not calibration:
            log.error("--calibration-images matched no images")
            return 1
        log.info(f"int8 calibration on {len(calibration)} images")
    predictor = OpenSetPredictor(
        args.checkpoint, n_classes=args.n_classes,
        variant=args.model_variant, image_size=args.image_size,
        threshold=args.threshold, mode=args.mode,
        has_background=args.background, optimize=args.optimize,
        calibration=calibration,
        calibration_percentile=args.calibration_percentile,
        device=device_of(args))
    if args.threshold_at_fpr is not None:
        predictor.threshold = calibrate_threshold(
            args.calibrate, args.threshold_at_fpr, predictor.mode,
            predictor.has_background)
        log.info(f"calibrated threshold {predictor.threshold:.6g} "
                 f"(FPR <= {args.threshold_at_fpr} on {args.calibrate})")
    if not args.no_warmup:
        log.info(f"warming up batch buckets to {args.max_batch} ...")
        predictor.warmup(args.max_batch)

    server = PredictionServer((args.host, args.port), predictor,
                              max_batch=args.max_batch,
                              window_ms=args.batch_window_ms,
                              request_timeout_s=args.request_timeout)
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    server.start()
    host, port = server.server_address[:2]
    log.info(f"serving {args.checkpoint} on http://{host}:{port} "
             f"(max_batch={server.batcher.max_batch}, "
             f"window={args.batch_window_ms}ms, device {predictor.device})")
    stop.wait()
    log.info("shutting down")
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
