"""Component registry: string name -> implementation.

The port's counterpart of the JAX package's ``utils/registry.py``. Names
resolve the same way: short names ("DNN"), the port's dotted names
("ultra_pytorch_tpu_torch.models.DNN") and reference-style dotted names
("ultra.ranking_model.DNN", which checkpoint metadata and
``configs/*.json`` carry) through the alias table. Nothing falls back to
the JAX package.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional

_REGISTRY: Dict[str, Dict[str, Any]] = {}  # kind -> {name -> obj}
_ALIASES: Dict[str, str] = {}  # reference-style dotted name -> "kind:name"

# Modules whose import populates the registry for each component kind.
_KIND_MODULES = {
    "ranker": "ultra_pytorch_tpu_torch.models",
    "algorithm": "ultra_pytorch_tpu_torch.algorithms",
    "feed": "ultra_pytorch_tpu_torch.input_layer",
}


def register(kind: str, name: str, aliases: Optional[List[str]] = None
             ) -> Callable[[Any], Any]:
    """Class/function decorator registering an implementation under `kind`."""

    def deco(obj: Any) -> Any:
        _REGISTRY.setdefault(kind, {})[name] = obj
        for alias in aliases or []:
            _ALIASES[alias] = f"{kind}:{name}"
        return obj

    return deco


def _ensure_loaded(kind: Optional[str] = None) -> None:
    mods = ([_KIND_MODULES[kind]] if kind in _KIND_MODULES
            else list(dict.fromkeys(_KIND_MODULES.values())))
    for m in mods:
        importlib.import_module(m)


def find_class(name: str, kind: Optional[str] = None) -> Any:
    """Resolve a component by short, dotted or reference-style name."""
    _ensure_loaded(kind)
    if name in _ALIASES:
        kind_, short = _ALIASES[name].split(":", 1)
        return _REGISTRY[kind_][short]
    short = name.rsplit(".", 1)[-1]
    kinds = [kind] if kind else list(_REGISTRY)
    for k in kinds:
        if short in _REGISTRY.get(k, {}):
            return _REGISTRY[k][short]
    raise KeyError(f"Unknown component {name!r} (kind={kind})")


def list_available(kind: str) -> List[str]:
    """List registered implementation names for a component kind."""
    _ensure_loaded(kind)
    return sorted(_REGISTRY.get(kind, {}))
