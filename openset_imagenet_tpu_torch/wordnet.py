"""Standalone WordNet/ImageNet hierarchy (replaces the ``robustness`` dep).

The port's own copy of :mod:`openset_imagenet_tpu.wordnet` (that package's
``__init__`` imports jax); the queries and their results are the same.

The reference builds its protocols on ``robustness.tools.imagenet_helpers.
ImageNetHierarchy`` (reference ``protocol.py:4,23``), which parses three
metadata files that ship with ImageNet tooling:

* ``wordnet.is_a.txt`` — one ``"<parent_wnid> <child_wnid>"`` edge per line;
* ``words.txt``        — ``"<wnid>\\t<comma-separated names>"`` per line;
* ``imagenet_class_index.json`` — the 1000 ILSVRC2012 classes as
  ``{"idx": [wnid, name], ...}``.

This module reimplements exactly the queries the protocol layer needs, with
**bug-for-bug descendant semantics**.  ``ImageNetHierarchy`` stores a SINGLE
``parent_wnid`` per node, overwritten by ``Node.add_child`` for every
``is_a`` edge read — so for multi-parent synsets the LAST edge in file
order wins, and "descendants of P" means "ImageNet classes whose unique
parent *chain* passes through P", NOT the transitive closure of the is-a
DAG.  Its ``descendants_all`` sets are populated by walking each ImageNet
class's parent chain to the root and adding the class to every node passed,
so they contain only in-ImageNet wnids (the reference's
``in_imagenet=True`` filter in ``protocol.py:100-112`` is a no-op).
:meth:`WordNetHierarchy.imagenet_descendants` reproduces that computation;
the true-DAG closure remains available as :meth:`descendants` /
:meth:`all_descendants_sorted` (extensions, not used by the protocols).

One deliberate divergence: ``robustness`` takes the in-ImageNet wnid set
from ``os.listdir(imagenet/train)``; here it comes from
``imagenet_class_index.json`` (same 1000 wnids for ILSVRC2012, but
deterministic and usable without the image tree).

``common_superclass_wnid('mixed_13')`` is reproduced as the MIXED_13
constant (the 13 superclass wnids the reference cites inline at
``protocol.py:62-76``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Set

# The 'mixed_13' superclass group (robustness's common_superclass_wnid):
# dog, bird, insect, furniture, fish, monkey, car, feline, truck, fruit,
# fungus, boat, computer.
MIXED_13 = (
    "n02084071", "n01503061", "n02159955", "n03405725", "n02512053",
    "n02484322", "n02958343", "n02120997", "n04490091", "n13134947",
    "n12992868", "n02858304", "n03082979",
)


class WordNetHierarchy:
    """Single-parent wnid hierarchy with robustness-parity descendant sets."""

    def __init__(self, metadata_path):
        meta = Path(metadata_path)
        self._children: Dict[str, List[str]] = {}
        # Last is_a edge wins: robustness Node.parent_wnid is one slot that
        # add_child overwrites per parsed line.
        self._parent: Dict[str, Optional[str]] = {}
        with open(meta / "wordnet.is_a.txt") as f:
            for line in f:
                parts = line.split()
                if len(parts) != 2:
                    continue
                parent, child = parts
                self._children.setdefault(parent, []).append(child)
                self._parent[child] = parent
                self._parent.setdefault(parent, None)

        self._names: Dict[str, str] = {}
        with open(meta / "words.txt") as f:
            for line in f:
                wnid, _, name = line.rstrip("\n").partition("\t")
                self._names[wnid] = name

        with open(meta / "imagenet_class_index.json") as f:
            index = json.load(f)
        # wnid per ILSVRC2012 class, in class-index order.
        self.in_wnids: List[str] = [v[0] for _, v in sorted(
            index.items(), key=lambda kv: int(kv[0]))]
        self._in_wnid_set: FrozenSet[str] = frozenset(self.in_wnids)

        # robustness ImageNetHierarchy.__init__ ascent: every ImageNet class
        # walks its parent chain to the root, adding itself to each node's
        # descendant set.  (The reference also propagates the class node's
        # own descendants_all along the walk; that changes nothing — any
        # class below w on a chain reaches w's ancestors via its own chain.)
        self._desc_in: Dict[str, Set[str]] = {}
        for w in self.in_wnids:
            seen: Set[str] = set()  # cycle guard (wordnet is acyclic)
            node = self._parent.get(w)
            while node is not None and node not in seen:
                seen.add(node)
                self._desc_in.setdefault(node, set()).add(w)
                node = self._parent.get(node)

        self._desc_cache: Dict[str, FrozenSet[str]] = {}

    def name_of(self, wnid: str) -> str:
        """Human-readable name(s) of a wnid (words.txt line)."""
        return self._names.get(wnid, wnid)

    def children(self, wnid: str) -> List[str]:
        return self._children.get(wnid, [])

    def parent_of(self, wnid: str) -> Optional[str]:
        """The node's (single, last-edge-wins) parent wnid."""
        return self._parent.get(wnid)

    def imagenet_descendants(self, wnid: str) -> List[str]:
        """Sorted ILSVRC2012 classes whose parent chain passes ``wnid``.

        Parity: the reference's ``get_descendants_wid(..., in_imagenet=
        True)`` (reference ``protocol.py:100-112``) over robustness's
        ``descendants_all``.  Unknown/childless wnids yield ``[]`` (the
        reference would KeyError on its pruned tree).
        """
        return sorted(self._desc_in.get(wnid, ()))

    def descendants(self, wnid: str) -> FrozenSet[str]:
        """True transitive DAG closure below ``wnid`` (extension).

        NOT the reference semantics for multi-parent synsets — protocol
        code must use :meth:`imagenet_descendants`.
        """
        cached = self._desc_cache.get(wnid)
        if cached is not None:
            return cached
        out: Set[str] = set()
        stack = list(self._children.get(wnid, ()))
        while stack:
            node = stack.pop()
            if node in out:
                continue
            out.add(node)
            stack.extend(self._children.get(node, ()))
        result = frozenset(out)
        self._desc_cache[wnid] = result
        return result

    def all_descendants_sorted(self, wnid: str) -> List[str]:
        """Sorted full DAG-closure descendant list (extension)."""
        return sorted(self.descendants(wnid))


def common_superclass_wnid(group: str):
    """Superclass-group lookup; only 'mixed_13' is used by the protocols."""
    if group == "mixed_13":
        return list(MIXED_13)
    raise KeyError(f"unknown superclass group {group!r}")
