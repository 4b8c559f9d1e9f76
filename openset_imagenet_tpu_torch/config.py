"""Configuration namespaces: nested mappings with attribute access.

Counterpart of :mod:`openset_imagenet_tpu.config` (``NameSpace`` and
``load_yaml``, ``NameSpace.dump``).  PyYAML is imported only inside
:func:`load_yaml` and :meth:`NameSpace.dump`, so the port runs where it
is not installed.
"""

from __future__ import annotations

import pathlib
from typing import Any, Mapping


class NameSpace:
    """Recursive attribute namespace over a nested mapping.

    Nested dicts become nested ``NameSpace`` objects; everything else is
    stored as-is.  ``dict()`` converts back; ``==`` compares by value while
    hashing stays by identity, as in the JAX package.
    """

    def __init__(self, config: Mapping[str, Any]):
        self.__dict__.update({
            name: NameSpace(value) if isinstance(value, dict) else value
            for name, value in config.items()})

    def __repr__(self) -> str:
        return "\n".join(f"{k}: {v}" for k, v in vars(self).items())

    __hash__ = object.__hash__

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, NameSpace):
            return NotImplemented
        return self.dict() == other.dict()

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def get(self, name: str, default: Any = None) -> Any:
        return self.__dict__.get(name, default)

    def dict(self) -> dict:
        return {k: v.dict() if isinstance(v, NameSpace) else v
                for k, v in vars(self).items()}

    def dump(self, indent: int = 4) -> str:
        """Serialise to YAML text (the sweep script's config round trip)."""
        import yaml

        return yaml.dump(_to_dumpable(self.dict()), indent=indent)


def _to_dumpable(obj: Any) -> Any:
    """Make values YAML-safe: pathlib paths become plain strings (the
    worker logs its config through it without PyYAML)."""
    if isinstance(obj, dict):
        return {k: _to_dumpable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_dumpable(v) for v in obj]
    if isinstance(obj, pathlib.PurePath):
        return str(obj)
    return obj


def load_yaml(yaml_file) -> NameSpace:
    """Load a YAML file into a nested :class:`NameSpace`."""
    import yaml

    with open(yaml_file, "r") as f:
        return NameSpace(yaml.safe_load(f))
