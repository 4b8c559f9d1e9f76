"""Train one (protocol, loss) run: the port's ``train_imagenet``.

    python -m openset_imagenet_tpu_torch.script.train config.yaml 1 -o out

Counterpart of the JAX CLI (``script/train.py:20-55``): a positional YAML
config and protocol, ``-o/--output-directory``, ``-g/--gpu`` (the run
goes to ``cuda:{gpu}``) and ``--nice``; the CLI overlays those fields on
the loaded config and calls :func:`~openset_imagenet_tpu_torch.train.
worker`.  ``--device cpu`` runs it on the host (the default is the card).
"""

from __future__ import annotations

import argparse
import os
import pathlib

from ..config import load_yaml
from ..train import worker


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        "train_imagenet_torch",
        description="Train an open-set ImageNet model (PyTorch port)")
    parser.add_argument("configuration", type=pathlib.Path,
                        help="Filename of the training configuration (YAML)")
    parser.add_argument("protocol", type=int, choices=(1, 2, 3),
                        help="Open-set protocol: 1, 2 or 3")
    parser.add_argument("-o", "--output-directory", default=".",
                        type=pathlib.Path,
                        help="Directory for trained models and logs")
    parser.add_argument("-g", "--gpu", type=int, nargs="?", default=None,
                        const=0, help="Run on this CUDA device index")
    parser.add_argument("--nice", type=int, default=20,
                        help="Process niceness (os.nice)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Train on the card (default) or on the host")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    try:
        # As the reference CLI: training runs niced (os.nice(20) unless
        # --nice says otherwise).
        os.nice(args.nice)
    except (OSError, AttributeError):
        pass
    cfg = load_yaml(args.configuration)
    if args.gpu is not None:
        cfg.gpu = args.gpu
    cfg.protocol = args.protocol
    cfg.output_directory = args.output_directory
    cfg.output_directory.mkdir(parents=True, exist_ok=True)
    return worker(cfg, device="cpu" if args.device == "cpu" else None)


if __name__ == "__main__":
    main()
