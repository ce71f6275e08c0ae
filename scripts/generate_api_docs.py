#!/usr/bin/env python3
"""Generate the rendered API reference into docs/api/ (markdown).

The counterpart of the reference's Doxygen setup
(/root/reference/docs/Doxyfile + docs/generate-docs.sh): walks every
module under the ``tpuwave`` package with :mod:`inspect` and emits one
markdown page per module (module docstring, then every public class with
its methods and every public function, each with signature + docstring),
plus an ``index.md`` grouped by subpackage. The output is committed so
the API reference ships with the repo and diffs reviewably.

Usage: JAX_PLATFORMS=cpu python scripts/generate_api_docs.py
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "docs" / "api"


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def document_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]

    # honour __all__ when present; otherwise take public members defined here
    exported = getattr(mod, "__all__", None)

    def members(pred):
        out = []
        for name, obj in inspect.getmembers(mod, pred):
            if exported is not None:
                if name not in exported:
                    continue
            elif not _is_public(name) or getattr(obj, "__module__", None) != modname:
                continue
            out.append((name, obj))
        return out

    classes = members(inspect.isclass)
    functions = members(inspect.isfunction)

    if classes:
        lines += ["## Classes", ""]
        for name, cls in classes:
            lines += [f"### `{name}{_signature(cls)}`", ""]
            if _doc(cls):
                lines += [_doc(cls), ""]
            for mname, meth in inspect.getmembers(cls, inspect.isfunction):
                if not _is_public(mname) or meth.__qualname__.split(".")[0] != name:
                    continue
                lines += [f"#### `{name}.{mname}{_signature(meth)}`", ""]
                if _doc(meth):
                    lines += [_doc(meth), ""]
            for mname, prop in inspect.getmembers(
                    cls, lambda o: isinstance(o, property)):
                if not _is_public(mname):
                    continue
                lines += [f"#### `{name}.{mname}` *(property)*", ""]
                if _doc(prop):
                    lines += [_doc(prop), ""]

    if functions:
        lines += ["## Functions", ""]
        for name, fn in functions:
            lines += [f"### `{name}{_signature(fn)}`", ""]
            if _doc(fn):
                lines += [_doc(fn), ""]

    return "\n".join(lines).rstrip() + "\n"


def main() -> int:
    import tpuwave

    OUT.mkdir(parents=True, exist_ok=True)
    modnames = ["tpuwave"]
    for info in pkgutil.walk_packages(tpuwave.__path__, prefix="tpuwave."):
        modnames.append(info.name)
    modnames = sorted(set(modnames))

    written = []
    for modname in modnames:
        try:
            page = document_module(modname)
        except Exception as e:  # keep going: one bad import != no docs
            print(f"WARN: {modname}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            continue
        fname = modname.replace(".", "_") + ".md"
        (OUT / fname).write_text(page)
        written.append((modname, fname))

    # index grouped by subpackage
    groups: dict[str, list] = {}
    for modname, fname in written:
        parts = modname.split(".")
        group = parts[1] if len(parts) > 1 else "(package root)"
        groups.setdefault(group, []).append((modname, fname))
    lines = ["# tpuwave API reference", "",
             "Generated by `scripts/generate_api_docs.py` from the live "
             "package (run it after changing public APIs and commit the "
             "result). Counterpart of the reference's Doxygen output.", ""]
    for group in sorted(groups):
        lines += [f"## {group}", ""]
        for modname, fname in sorted(groups[group]):
            mod = importlib.import_module(modname)
            first = (_doc(mod).splitlines() or [""])[0]
            lines.append(f"- [`{modname}`]({fname}) — {first}")
        lines.append("")
    (OUT / "index.md").write_text("\n".join(lines))
    print(f"wrote {len(written)} module pages + index.md to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
