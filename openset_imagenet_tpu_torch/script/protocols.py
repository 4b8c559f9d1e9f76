"""Generate the open-set protocol CSVs: the port's ``protocols_imagenet``.

    python -m openset_imagenet_tpu_torch.script.protocols --protocols 1

Counterpart of the JAX CLI (``script/protocols.py``), whose files it
writes byte for byte.  Parity with reference ``script/protocols.py:7-63``:
same flags
(``--protocols`` default ``(1, 2, 3)``, ``--imagenet-directory``,
``--metadata-directory``, ``--output-directory`` default ``protocols``,
``--tex-files``, ``--seed`` default 42) and the same per-protocol flow:
build class sets, create datasets, print composition, save CSVs, optionally
write the LaTeX class table.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..protocol import OpenSetProtocol


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        "protocols_imagenet_torch",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--protocols", type=int, nargs="+", default=(1, 2, 3),
                        help="Open set protocol: 1, 2 or 3")
    parser.add_argument("--imagenet-directory", type=Path,
                        default="/local/scratch/datasets/ImageNet/ILSVRC2012/",
                        help="ILSVRC2012 root (must contain train/ and val/)")
    parser.add_argument("--metadata-directory", type=Path,
                        default=("/local/scratch/datasets/ImageNet/"
                                 "ILSVRC2012/robustness"),
                        help="Directory of metadata files (imagenet_class_"
                             "index.json, wordnet.is_a.txt, words.txt)")
    parser.add_argument("--output-directory", type=Path, default="protocols",
                        help="Directory to save protocol files")
    parser.add_argument("--tex-files", "-t", type=Path, nargs="+",
                        help="Write class lists to these files, "
                             "one per protocol")
    parser.add_argument("--seed", type=int, default=42,
                        help="Random seed; different seeds give different "
                             "protocols!")
    args = parser.parse_args(argv)
    if args.tex_files is not None and \
            len(args.tex_files) != len(args.protocols):
        raise ValueError(
            f"--tex-files wants exactly one file per protocol: got "
            f"{len(args.tex_files)} file(s) for {len(args.protocols)} "
            "protocol(s)")
    return args


def main(argv=None):
    args = get_args(argv)
    tex_targets = args.tex_files or [None] * len(args.protocols)
    for protocol_num, tex_file in zip(args.protocols, tex_targets):
        protocol = OpenSetProtocol(
            imagenet_dir=args.imagenet_directory,
            metadata_path=args.metadata_directory,
            protocol_num=protocol_num)
        protocol.create_dataset(random_state=args.seed)
        protocol.print_data()
        protocol.save_datasets_to_csv(args.output_directory)
        if tex_file is not None:
            protocol.write_class_list(tex_file)


if __name__ == "__main__":
    main()
