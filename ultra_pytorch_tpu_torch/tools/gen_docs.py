"""Generate the port's markdown docs: API reference and algorithm guide.

The port's counterpart of the JAX package's ``tools/gen_docs.py``, from
the port alone (its docstrings and its component registry):

  docs/torch_api.md        - every module under ultra_pytorch_tpu_torch/:
                             its docstring's first paragraph and its public
                             classes and functions with their signatures
  docs/torch_algorithms.md - one section a registered learning algorithm:
                             its docstring and default-hyperparameter table

Nothing here needs a device: ``--device`` is accepted as every tool's is,
and the modules are only imported.

Usage: python -m ultra_pytorch_tpu_torch.tools.gen_docs [--out DIR]
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import pkgutil
import sys
from typing import Dict

from ultra_pytorch_tpu_torch.tools import bench_common as bc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _first_paragraph(doc: str) -> str:
    doc = inspect.cleandoc(doc or "")
    return doc.split("\n\n", 1)[0].strip() if doc else ""


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if (inspect.isclass(obj) or inspect.isfunction(obj)) and getattr(
                obj, "__module__", None) == mod.__name__:
            out.append((n, obj))
    return out


def gen_api_md() -> str:
    import ultra_pytorch_tpu_torch

    lines = [
        "# API reference of the PyTorch/CUDA port",
        "",
        "Generated from the docstrings of `ultra_pytorch_tpu_torch` "
        "(`python -m ultra_pytorch_tpu_torch.tools.gen_docs`).",
        "",
    ]
    mods = sorted(m.name for m in pkgutil.walk_packages(
        ultra_pytorch_tpu_torch.__path__, prefix="ultra_pytorch_tpu_torch."))
    for name in mods:
        mod = importlib.import_module(name)
        members = _public_members(mod)
        doc = _first_paragraph(mod.__doc__)
        if not doc and not members:
            continue
        lines += [f"## `{name}`", ""]
        if doc:
            lines += [doc, ""]
        for n, obj in members:
            kind = "class" if inspect.isclass(obj) else "def"
            lines += [f"### {kind} `{n}{_signature(obj)}`", ""]
            summary = _first_paragraph(obj.__doc__)
            if summary:
                lines += [summary, ""]
            if inspect.isclass(obj):
                for mn, meth in sorted(vars(obj).items()):
                    if mn.startswith("_") or not inspect.isfunction(meth):
                        continue
                    msum = _first_paragraph(meth.__doc__)
                    lines.append(f"- `{mn}{_signature(meth)}`"
                                 + (f" — {msum.splitlines()[0]}" if msum
                                    else ""))
                lines.append("")
    return "\n".join(lines) + "\n"


def default_hparams_of(cls) -> Dict:
    """A component's default hparams, from its class alone."""
    return cls.default_hparams(object.__new__(cls))


def gen_algorithms_md() -> str:
    from ultra_pytorch_tpu_torch.utils import registry

    lines = [
        "# Learning algorithms of the PyTorch/CUDA port",
        "",
        "One section a registered algorithm (generated by "
        "`python -m ultra_pytorch_tpu_torch.tools.gen_docs`). Select one "
        "in the experiment JSON by short name (`\"learning_algorithm\": "
        "\"DLA\"`) or by the reference's dotted name "
        "(`\"ultra.learning_algorithm.DLA\"`).",
        "",
    ]
    for name in registry.list_available("algorithm"):
        cls = registry.find_class(name, kind="algorithm")
        mod = importlib.import_module(cls.__module__)
        doc = (cls.__doc__ or "").strip() or (mod.__doc__ or "").strip()
        lines += [f"## {name}", ""]
        if doc:
            lines += [inspect.cleandoc(doc), ""]
        hps = default_hparams_of(cls)
        if hps:
            lines += ["| hyperparameter | default |", "|---|---|"]
            lines += [f"| `{k}` | `{v!r}` |" for k, v in hps.items()]
            lines.append("")
    return "\n".join(lines) + "\n"


def main(argv=None) -> Dict:
    p = bc.tool_parser(__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(ROOT, "docs"),
                   help="directory of the two files (default the "
                        "checkout's docs/)")
    args = p.parse_args(argv)
    bc.start(args)
    os.makedirs(args.out, exist_ok=True)
    written = {}
    for fname, gen in (("torch_api.md", gen_api_md),
                       ("torch_algorithms.md", gen_algorithms_md)):
        path = os.path.join(args.out, fname)
        text = gen()
        with open(path, "w") as fout:
            fout.write(text)
        written[fname] = {"path": path, "lines": text.count("\n")}
        print(path, file=sys.stderr)
    out = {"docs": written}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
