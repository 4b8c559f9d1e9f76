"""The 3 losses x 3 protocols sweep: the port's ``train_imagenet_all``.

    python -m openset_imagenet_tpu_torch.script.train_all -o experiments

Counterpart of the JAX CLI (``script/train_all.py``, reference
``script/train_all.py:14-118``), with its flags (``--protocols`` default
``(3, 1, 2)``, ``--loss-functions``, ``--output-directory``, ``--gpus``,
``--nice``, ``--continue-training``, ``--dry-run``) and ``--device``:
each ``(protocol, loss)`` run gets its mutated YAML config under
``Protocol_{p}/`` (a continued run points ``checkpoint`` at its
``{loss}_curr.pth``) and one child ``python -m
openset_imagenet_tpu_torch.script.train``.  With ``--gpus`` the runs
round-robin over one queue per card, each child pinned with ``--gpu i``
(the worker then runs on ``cuda:i``); without it they run one after the
other on the default card.  The configs are YAML, so this CLI needs
PyYAML.
"""

from __future__ import annotations

import argparse
import multiprocessing.pool
import os
import pathlib
import subprocess
import sys


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        "train_imagenet_all_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--configuration", type=pathlib.Path,
                        default=pathlib.Path("config/train.yaml"),
                        help="The configuration file defining the experiment")
    parser.add_argument("--protocols", type=int, choices=(1, 2, 3),
                        nargs="+", default=(3, 1, 2),
                        help="Protocols to execute")
    parser.add_argument("--loss-functions", "-l", nargs="+",
                        choices=("entropic", "softmax", "garbage"),
                        default=("entropic", "softmax", "garbage"),
                        help="Loss functions to train")
    parser.add_argument("--output-directory", "-o", type=pathlib.Path,
                        default="experiments",
                        help="Directory to save trained models")
    parser.add_argument("--gpus", "-g", type=int, nargs="+",
                        help="CUDA device indexes for process-parallel "
                             "runs, one queue each; omit for one "
                             "sequential queue")
    parser.add_argument("--nice", type=int, default=20,
                        help="Process priority")
    parser.add_argument("--continue-training", "-c", action="store_true",
                        help="Resume runs whose _curr checkpoint exists")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Train on the card (default) or on the host")
    parser.add_argument("--dry-run", action="store_true",
                        help="Materialize the per-run configs and print "
                             "the run commands without executing (per-run "
                             "YAMLs are regenerated from the base config "
                             "on every launch, dry or real)")
    args = parser.parse_args(argv)
    args.parallel = args.gpus is not None and len(args.gpus) > 1
    return args


def materialize_run_config(args, protocol: int, loss_function: str):
    """Write one run's YAML under ``Protocol_{p}/`` and return its path.

    The base config is re-loaded per run with ``loss.type``/``name``/
    ``log_name`` mutated; ``--continue-training`` probes for an existing
    ``{loss}_curr.pth`` and points ``checkpoint`` at it when found
    (reference ``script/train_all.py:60-64``).
    """
    from ..config import load_yaml

    run_dir = os.path.join(args.output_directory, f"Protocol_{protocol}")
    os.makedirs(run_dir, exist_ok=True)
    cfg = load_yaml(args.configuration)
    cfg.loss.type = loss_function
    cfg.name = loss_function
    cfg.parallel = args.parallel
    cfg.log_name = f"{loss_function}.log"
    if args.continue_training:
        probe = os.path.join(run_dir, f"{loss_function}_curr.pth")
        if os.path.exists(probe):
            cfg.checkpoint = probe
    cfg_path = os.path.join(run_dir, f"{loss_function}.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg.dump())
    return cfg_path, run_dir


def commands(args):
    """Split the (protocol x loss) sweep into per-device run queues.

    With ``--gpus`` the runs round-robin over one queue per device index
    and each child is pinned to its queue's card via ``--gpu``; without
    it everything lands in one sequential queue.
    """
    n_queues = len(args.gpus) if args.gpus is not None else 1
    queues = [[] for _ in range(n_queues)]
    sweep = [(p, l) for p in args.protocols for l in args.loss_functions]
    for i, (protocol, loss_function) in enumerate(sweep):
        cfg_path, run_dir = materialize_run_config(args, protocol,
                                                   loss_function)
        call = [sys.executable, "-m",
                "openset_imagenet_tpu_torch.script.train",
                cfg_path, str(protocol), "--output-directory", run_dir,
                "--nice", str(args.nice), "--device", args.device]
        queue = i % n_queues
        if args.gpus is not None:
            call += ["--gpu", str(args.gpus[queue])]
        queues[queue].append(call)
    return queues


def run_queue(queue):
    for call in queue:
        print("sweep: launching " + " ".join(call))
        subprocess.call(call)


def main(argv=None):
    args = get_args(argv)
    queues = commands(args)
    if args.dry_run:
        for queue in queues:
            for call in queue:
                print(" ".join(call))
        return
    if args.parallel:
        with multiprocessing.pool.ThreadPool(len(args.gpus)) as pool:
            pool.map(run_queue, queues)
    else:
        for queue in queues:
            run_queue(queue)


if __name__ == "__main__":
    main()
