"""Typed hyper-parameter registry with the ULTRA comma-string grammar.

The PyTorch port's own copy of the JAX package's ``utils/hparams.py``
(pure Python, kept separate so the port imports nothing of the JAX
package); the two parse every settings string identically.

Behaviorally compatible with the reference's TF1-era ``HParams`` port
(ref ``ultra/utils/hparams.py:262-574``): every feed / ranker / algorithm
declares typed defaults and then parses an override string such as

    "learning_rate=0.01,hidden_layer_sizes=[512,256,128],loss_func=softmax_loss"

Supported forms (ref grammar ``ultra/utils/hparams.py:160-260``):
  - scalar assignment      ``name=value``
  - list assignment        ``name=[v1,v2,...]``
  - indexed assignment     ``name[3]=value`` (sparse update of a list hparam)

Types are inferred from the declared default; values are cast with the same
"compatible cast" rules (int -> float promotion allowed, no float -> int).
This is a fresh implementation, not a port of the reference's parser.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List

_PARAM_RE = re.compile(
    r"""
    (?P<name>[a-zA-Z][\w]*)          # hparam name
    (?:\[(?P<index>\d+)\])?          # optional [index]
    \s*=\s*
    (?P<value>
        \[[^\]]*\]                   # bracketed list
        | [^,\[]*                    # or scalar up to next comma
    )
    ($|,\s*)
    """,
    re.VERBOSE,
)

_TRUE = {"true", "1", "t", "y", "yes"}
_FALSE = {"false", "0", "f", "n", "no"}


def _cast_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"Could not parse {s!r} as bool")


def _cast_to(value: str, proto: Any, name: str) -> Any:
    """Cast a string to the type of `proto`, with int->float promotion only."""
    value = value.strip()
    if isinstance(proto, bool):
        return _cast_bool(value)
    if isinstance(proto, int):
        f = float(value)
        if f != int(f):
            raise ValueError(
                f"Could not cast {value!r} to int for hparam {name!r}")
        return int(f)
    if isinstance(proto, float):
        return float(value)
    return value  # string


class HParams:
    """A typed name -> value registry parsed from comma strings."""

    def __init__(self, **kwargs: Any):
        self._params: Dict[str, Any] = {}
        for name, value in kwargs.items():
            self.add_hparam(name, value)

    # -- registry ---------------------------------------------------------
    def add_hparam(self, name: str, value: Any) -> None:
        if name in self._params or hasattr(self, name):
            raise ValueError(f"Hyperparameter name is reserved: {name}")
        if isinstance(value, (list, tuple)):
            if not value:
                raise ValueError(
                    f"Empty list default for hparam {name!r}: type is ambiguous")
            value = list(value)
        self._params[name] = value

    def set_hparam(self, name: str, value: Any) -> None:
        if name not in self._params:
            raise KeyError(f"Unknown hyperparameter: {name}")
        self._params[name] = value

    def get(self, name: str, default: Any = None) -> Any:
        return self._params.get(name, default)

    def __getattr__(self, name: str) -> Any:
        params = self.__dict__.get("_params")
        if params is not None and name in params:
            return params[name]
        raise AttributeError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._params

    def values(self) -> Dict[str, Any]:
        return dict(self._params)

    def to_json(self) -> str:
        return json.dumps(self._params, sort_keys=True)

    def __repr__(self) -> str:
        return f"HParams({self._params!r})"

    # -- parsing ----------------------------------------------------------
    def parse(self, values: str) -> "HParams":
        """Parse a comma-separated override string into this registry.

        Unknown names raise ValueError, matching the reference's behavior of
        rejecting overrides for undeclared hparams.
        """
        if not values:
            return self
        pos = 0
        while pos < len(values):
            m = _PARAM_RE.match(values, pos)
            if not m or m.start() != pos:
                raise ValueError(
                    f"Malformed hyperparameter string at: {values[pos:]!r}")
            pos = m.end()
            name = m.group("name")
            index = m.group("index")
            raw = m.group("value").strip()
            if name not in self._params:
                raise ValueError(f"Unknown hyperparameter: {name!r}")
            default = self._params[name]

            if index is not None:
                if not isinstance(default, list):
                    raise ValueError(
                        f"Indexed assignment on non-list hparam {name!r}")
                idx = int(index)
                lst = list(default)
                if idx >= len(lst):
                    lst.extend([lst[-1]] * (idx + 1 - len(lst)))
                lst[idx] = _cast_to(raw, default[0], name)
                self._params[name] = lst
            elif isinstance(default, list):
                if not (raw.startswith("[") and raw.endswith("]")):
                    raise ValueError(
                        f"List hparam {name!r} needs bracketed value, got {raw!r}")
                inner = raw[1:-1].strip()
                items: List[str] = [s for s in inner.split(",") if s.strip()] if inner else []
                self._params[name] = [_cast_to(s, default[0], name) for s in items]
            else:
                self._params[name] = _cast_to(raw, default, name)
        return self
