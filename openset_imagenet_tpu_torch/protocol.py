"""Open-set protocol generation: WordNet-derived class splits + CSVs.

The port's own copy of :mod:`openset_imagenet_tpu.protocol` (that
package's ``__init__`` imports jax): the same class sets, labels, split
and files, byte for byte.  Behavioral parity with reference
``protocol.py:8-383`` (component C1), with the ``robustness`` dependency
replaced by the standalone :mod:`.wordnet` hierarchy:

* **Protocol 1** — knowns: descendants of *dog*; negatives: other canids/
  carnivores/ungulates/primates; unknowns: food/motor-vehicle/device
  (reference ``protocol.py:27-43``).
* **Protocol 2** — descendants of *hunting dog*, first half known, second
  half negative (list sorted, split at the middle, reference
  ``protocol.py:45-56,146-153``); unknowns: other animal superclasses.
* **Protocol 3** — the 'mixed_13' superclasses with an index-based
  known/negative/unknown interleave (even -> known; odd divisible by 3 ->
  unknown; other odd -> negative; reference ``protocol.py:57-76,155-165``)
  plus extra unknown superclasses.

Labels: knowns ``0..N-1`` in sorted-wnid order, negatives ``-1``, unknowns
``-2`` (reference ``protocol.py:192-204``).  Train/val: stratified 80/20
split of ImageNet-train with a fixed seed via sklearn (identical splits to
the reference, ``protocol.py:245-250``); test: ImageNet-val images of all
three groups.  CSVs are ``p{P}_{train,val,test}.csv`` with
``relative/path,label`` rows (reference ``protocol.py:219-230``).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from .wordnet import WordNetHierarchy, common_superclass_wnid

# Superclass tables per protocol (reference protocol.py:27-84).
_P1_KNOWN = ("n02084071",)  # dog
_P1_NEG = (
    "n02118333",  # fox
    "n02115335",  # wild_dog
    "n02114100",  # wolf
    "n02120997",  # feline
    "n02131653",  # bear
    "n02441326",  # musteline
    "n02370806",  # ungulate
    "n02469914",  # primate
)
_P1_UNK = (
    "n07555863",  # food
    "n03791235",  # motor_vehicle
    "n03183080",  # device
)

_P2_KNOWN = ("n02087122",)  # hunting_dog
_P2_UNK = (
    "n02085374",  # toy_dog
    "n02118333",  # fox
    "n02115335",  # wild_dog
    "n02114100",  # wolf
    "n02120997",  # feline
    "n02131653",  # bear
    "n02441326",  # musteline mammal
    "n02370806",  # ungulate
)

_P3_UNK = (
    "n01661091",  # reptile
    "n03051540",  # clothing
    "n02370806",  # ungulate
    "n07707451",  # vegetable
    "n02686568",  # aircraft
)


class OpenSetProtocol:
    """Builds one of the three WACV'23 open-set ImageNet protocols."""

    def __init__(self, imagenet_dir, metadata_path, protocol_num: int = 1):
        """Args mirror reference ``protocol.py:11-26``.

        Args:
            imagenet_dir: ILSVRC2012 root (contains ``train/`` and ``val/``).
            metadata_path: directory with ``imagenet_class_index.json``,
                ``wordnet.is_a.txt`` and ``words.txt``.
            protocol_num: 1, 2 or 3.
        """
        if protocol_num not in (1, 2, 3):
            raise Exception("Choose between [1,2,3]")
        self.imagenet_dir = Path(imagenet_dir)
        self.metadata_path = Path(metadata_path)
        self.hierarchy = WordNetHierarchy(metadata_path)
        self.protocol = protocol_num
        self.data: Dict[str, List[Tuple[str, int]]] = {}

        if protocol_num == 1:
            self.kn_superclasses = list(_P1_KNOWN)
            self.neg_superclasses = list(_P1_NEG)
            self.unk_superclasses = list(_P1_UNK)
        elif protocol_num == 2:
            self.kn_superclasses = list(_P2_KNOWN)
            self.neg_superclasses = list(_P2_KNOWN)
            self.unk_superclasses = list(_P2_UNK)
        else:
            self.kn_superclasses = common_superclass_wnid("mixed_13")
            self.neg_superclasses = None
            self.unk_superclasses = list(_P3_UNK)

        self.kn_classes: List[str] = []
        self.neg_classes: List[str] = []
        self.unk_classes: List[str] = []
        self.label_map: Dict[str, int] = {}

    @property
    def neg_classes(self) -> List[str]:
        return self._neg_classes

    @neg_classes.setter
    def neg_classes(self, value) -> None:
        # The setter keeps the O(1) membership set for get_label in sync
        # with ANY assignment — including a direct equal-length replacement
        # between get_label calls, which a lazy length check could not
        # distinguish from the current list.
        self._neg_classes = list(value)
        self._neg_set = frozenset(self._neg_classes)

    # -- class-set construction (reference protocol.py:125-168) ------------
    def get_descendants_wid(self, wnid: str, in_imagenet: bool = True):
        """Sorted descendant class list (reference ``protocol.py:100-112``).

        Both branches return the same in-ImageNet chain-descendant set:
        robustness's ``descendants_all`` only ever contains in-ImageNet
        wnids, so the reference's ``in_imagenet`` flag does not change the
        result (see :mod:`.wordnet`).
        """
        del in_imagenet  # parity: a no-op flag in the reference, kept
        return self.hierarchy.imagenet_descendants(wnid)

    def _grouped_classes(self):
        """(known, negative, unknown) wnid lists before dedup/sort."""
        kn: List[str] = []
        neg: List[str] = []
        unk: List[str] = []
        if self.protocol == 1:
            for sc in self.kn_superclasses:
                kn.extend(self.get_descendants_wid(sc))
            for sc in self.neg_superclasses:
                neg.extend(self.get_descendants_wid(sc))
            for sc in self.unk_superclasses:
                unk.extend(self.get_descendants_wid(sc))
        elif self.protocol == 2:
            pool: List[str] = []
            for sc in self.kn_superclasses:
                pool.extend(self.get_descendants_wid(sc))
            half = len(pool) // 2
            kn.extend(pool[:half])
            neg.extend(pool[half:])
            for sc in self.unk_superclasses:
                unk.extend(self.get_descendants_wid(sc))
        else:
            for sc in self.kn_superclasses:
                for idx, wnid in enumerate(self.get_descendants_wid(sc)):
                    if idx % 2 == 0:
                        kn.append(wnid)
                    elif idx % 3 == 0:
                        unk.append(wnid)
                    else:
                        neg.append(wnid)
            for sc in self.unk_superclasses:
                unk.extend(self.get_descendants_wid(sc))
        return kn, neg, unk

    def update_classes(self) -> None:
        """Populate deduplicated, sorted class lists + the label map."""
        kn, neg, unk = self._grouped_classes()
        self.kn_classes = sorted(set(kn))
        self.neg_classes = sorted(set(neg))
        self.unk_classes = sorted(set(unk))
        self.label_map = {wnid: i for i, wnid in enumerate(self.kn_classes)}

    def get_label(self, class_name: str) -> int:
        """0..N-1 for knowns, -1 negatives, -2 unknowns."""
        if class_name in self.label_map:
            return self.label_map[class_name]
        # O(1) set membership: called once per image over ~hundreds of
        # thousands of images (the list scan was the builder's hot spot).
        # The neg_classes property setter keeps _neg_set in sync with every
        # assignment, so it is never stale here.
        if class_name in self._neg_set:
            return -1
        return -2

    # -- image discovery (reference protocol.py:114-123,170-190) -----------
    def query_images(self, target_classes: Sequence[str],
                     imagenet_split: str):
        """All image paths + owning class wnid for the given classes."""
        if imagenet_split not in ("train", "val"):
            raise Exception(
                "Imagenet data should be in train or val directory")
        images: List[str] = []
        classes: List[str] = []
        for wnid in target_classes:
            class_dir = self.imagenet_dir / imagenet_split / wnid
            for p in sorted(class_dir.glob("*")):
                images.append("/".join(p.parts[-3:]))
                classes.append(wnid)
        return images, classes

    # -- dataset assembly (reference protocol.py:232-263) -------------------
    def create_dataset(self, random_state: int = 42) -> None:
        """Build train/val (stratified 80/20 of ImageNet-train) + test."""
        from sklearn.model_selection import train_test_split

        self.update_classes()
        images, classes = self.query_images(
            [*self.kn_classes, *self.neg_classes], "train")
        x_train, x_val, y_train, y_val = train_test_split(
            images, classes, train_size=0.8, stratify=classes,
            random_state=random_state)
        self.data["train"] = list(zip(x_train,
                                      (self.get_label(c) for c in y_train)))
        self.data["val"] = list(zip(x_val,
                                    (self.get_label(c) for c in y_val)))

        images, classes = self.query_images(
            [*self.kn_classes, *self.neg_classes, *self.unk_classes], "val")
        self.data["test"] = list(zip(images,
                                     (self.get_label(c) for c in classes)))

    def save_datasets_to_csv(self, out_dir) -> None:
        """Write ``p{P}_{train,val,test}.csv`` (reference protocol.py:219)."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for split in ("train", "val", "test"):
            with open(out_dir / f"p{self.protocol}_{split}.csv", "w",
                      encoding="utf-8", newline="") as f:
                csv.writer(f).writerows(self.data[split])
        print(f"Protocol files saved in {out_dir}")

    # -- reporting (reference protocol.py:265-383) ---------------------------
    def image_counts(self, which_set: str) -> Tuple[int, int, int]:
        """(known, negative, unknown) sample counts of a split."""
        k = n = u = 0
        for _, label in self.data[which_set]:
            if label == -1:
                n += 1
            elif label == -2:
                u += 1
            else:
                k += 1
        return k, n, u

    def print_data(self) -> None:
        """Console summary of the protocol composition."""
        print(f"\nProtocol {self.protocol}")
        print(f"Known classes: {len(self.kn_classes)}")
        print(f"Negative classes: {len(self.neg_classes)}")
        print(f"Unknown classes: {len(self.unk_classes)}")
        for split in ("train", "val", "test"):
            k, n, u = self.image_counts(split)
            print(f"{split}: size={len(self.data[split])} "
                  f"known={k} negative={n} unknown={u}")

    def _class_table_columns(self):
        """(known, negative, unknown) columns of (wnid, is_superclass)."""
        def with_super(super_ids):
            col = []
            for sc in super_ids:
                col.append((sc, True))
                col.extend((d, False) for d in self.get_descendants_wid(sc))
            return col

        if self.protocol == 1:
            return (with_super(self.kn_superclasses),
                    with_super(self.neg_superclasses),
                    with_super(self.unk_superclasses))
        if self.protocol == 2:
            pool: List[str] = []
            known = [(sc, True) for sc in self.kn_superclasses]
            negative = [(sc, True) for sc in self.kn_superclasses]
            for sc in self.kn_superclasses:
                pool.extend(self.get_descendants_wid(sc))
            half = len(pool) // 2
            known += [(d, False) for d in pool[:half]]
            negative += [(d, False) for d in pool[half:]]
            return known, negative, with_super(self.unk_superclasses)
        known, negative, unknown = [], [], []
        for sc in self.kn_superclasses:
            known.append((sc, True))
            negative.append((sc, True))
            unknown.append((sc, True))
            for idx, wnid in enumerate(self.get_descendants_wid(sc)):
                if idx % 2 == 0:
                    known.append((wnid, False))
                elif idx % 3 == 0:
                    unknown.append((wnid, False))
                else:
                    negative.append((wnid, False))
        unknown += with_super(self.unk_superclasses)
        return known, negative, unknown

    def write_class_list(self, texfile) -> None:
        """LaTeX three-column class table (reference protocol.py:265-342)."""
        columns = self._class_table_columns()
        rows = max(len(c) for c in columns)

        def cell(col, i):
            if i >= len(col):
                return " &  & "
            wnid, is_super = col[i]
            prefix = "\\it " if is_super else "\\qquad "
            name = self.hierarchy.name_of(wnid).split(",")[0][:20]
            return f"{prefix}{wnid} & {prefix}{name} & "

        with open(texfile, "w") as f:
            for i in range(rows):
                line = "".join(cell(col, i) for col in columns)
                # Strip the trailing column separator, close the row.
                f.write(line[:-3] + "\\\\\n")
