"""Extract logits, features and scores of val and test: the port's
``evaluate_imagenet``.

    python -m openset_imagenet_tpu_torch.script.evaluate entropic 1 -o out

Counterpart of the JAX CLI (``script/evaluate.py``, reference
``script/evaluate.py:15-149``), with its flags and ``--device {cuda,cpu}``
(default the card; ``-g/--gpu N`` runs on ``cuda:N``).  It loads the
``_curr`` (or, with ``-b``, ``_best``) checkpoint of a ``(loss,
protocol)`` run, rebuilds the model with the evaluation n_classes rule
(garbage: ``label_count``; else ``label_count - 1``) and the architecture
the checkpoint stored (``--model-variant`` wins; a reference ``.pth``
gives resnet50), runs both splits through :func:`~..train.get_arrays`
and writes ``{loss}_{split}_arr{_curr|_best}.npz`` with ``gt, logits,
features, scores``.  The reference quirk stays: val and test are loaded
without label surgery (negatives stay -1 / -2); a garbage model's scores
have the extra background column.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        "evaluate_imagenet_torch",
        description="Extract logits/features/scores for val+test "
                    "(PyTorch port)")
    parser.add_argument("loss", choices=("entropic", "softmax", "garbage"),
                        help="Loss function used at training time")
    parser.add_argument("protocol", type=int, choices=(1, 2, 3),
                        help="Open-set protocol")
    parser.add_argument("--use-best", "-b", action="store_true",
                        help="Load the _best checkpoint instead of _curr")
    parser.add_argument("--gpu", "-g", type=int, nargs="?", default=None,
                        const=0, help="Run on this CUDA device index")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Evaluate on the card (default) or on the host")
    parser.add_argument("--imagenet-directory",
                        default="/local/scratch/datasets/ImageNet/ILSVRC2012/",
                        help="ImageNet root directory")
    parser.add_argument("--protocol-directory", default="protocols",
                        help="Directory holding the p{}_{split}.csv files")
    parser.add_argument("--output-directory", "-o",
                        default="experiments/Protocol_{}",
                        help="Directory with checkpoints; receives the npz; "
                             "'{}' is replaced by the protocol number")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--model-variant", default=None,
                        help="Model architecture; default reads the "
                             "variant stored in the checkpoint "
                             "(resnet50 for checkpoints without "
                             "metadata, e.g. the reference's)")
    parser.add_argument("--reader", default="auto",
                        choices=("auto", "native", "pil", "synthetic"))
    args = parser.parse_args(argv)
    try:
        args.output_directory = args.output_directory.format(args.protocol)
    except (IndexError, KeyError, ValueError):
        # Not a format template (stray/unmatched braces): use literally.
        pass
    return args


def main(argv=None) -> dict:
    """Run the CLI; returns ``{split: {"path", "rows", "seconds"}}`` (the
    seconds of the split's ``get_arrays`` on the host clock)."""
    args = get_args(argv)
    import torch

    from ..checkpoint import load_weights_any_format, resolve_model_cfg
    from ..config import NameSpace
    from ..dataset import ImagenetDataset
    from ..logger import configure_logger
    from ..pipeline import pipeline_from_dataset
    from .. import train as engine

    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda" if args.gpu is None
                              else f"cuda:{args.gpu}")
    log = configure_logger()
    out_dir = pathlib.Path(args.output_directory)
    proto_dir = pathlib.Path(args.protocol_directory)
    suffix = "_best" if args.use_best else "_curr"

    # Datasets WITHOUT label surgery (reference script/evaluate.py:92-100).
    val_ds = ImagenetDataset(proto_dir / f"p{args.protocol}_val.csv",
                             args.imagenet_directory)
    test_ds = ImagenetDataset(proto_dir / f"p{args.protocol}_test.csv",
                              args.imagenet_directory)

    # Evaluation n_classes rule (reference script/evaluate.py:118-121):
    # garbage keeps the background class; others drop the -1 label column.
    if args.loss == "garbage":
        n_classes = val_ds.label_count
    else:
        n_classes = val_ds.label_count - 1

    ckpt = out_dir / f"{args.loss}{suffix}.pth"
    cfg = NameSpace({"model": resolve_model_cfg(ckpt, args.model_variant),
                     "data": {"reader": args.reader},
                     "workers": args.workers, "seed": 42})
    # Built without drawing weights; the checkpoint fills every tensor.
    model = engine.build_model(cfg, n_classes, device="meta")
    model.to_empty(device=device)
    epoch, best_score = load_weights_any_format(ckpt, model)
    model.eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    log.info(f"Loaded {ckpt} (epoch {epoch}, score {best_score:.3f}, "
             f"variant {cfg.model.variant}) on {device}")

    forward = engine.make_forward_step()
    reader = engine._make_reader(cfg, crop=args.image_size)
    written = {}
    for split, ds in (("val", val_ds), ("test", test_ds)):
        pipe = pipeline_from_dataset(
            ds, args.batch_size, is_training=False, seed=42,
            num_workers=args.workers, reader=reader,
            pin_memory=device.type == "cuda")
        t0 = time.perf_counter()
        try:
            gt, logits, features, scores = engine.get_arrays(
                model, pipe, forward_step=forward)
        finally:
            pipe.close()
        seconds = time.perf_counter() - t0
        file_path = out_dir / f"{args.loss}_{split}_arr{suffix}.npz"
        np.savez(file_path, gt=gt, logits=logits, features=features,
                 scores=scores)
        log.info(f"Target labels, logits, features and scores saved in: "
                 f"{file_path} ({len(gt)} rows, {seconds:.2f} s)")
        written[split] = {"path": file_path, "rows": len(gt),
                          "seconds": seconds}
    return written


if __name__ == "__main__":
    main()
