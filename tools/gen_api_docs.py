"""Generate docs/api/ markdown from the package's docstrings.

The reference engine ships an mkdocstrings-rendered API section
(/root/reference/docs/api/*); this tool produces the same artifact for this
engine straight from ``__all__`` + docstrings, so the pages can never drift
from the code. Rerun after changing any public signature/docstring:

    python tools/gen_api_docs.py
"""

from __future__ import annotations

import importlib
import inspect
import sys
from pathlib import Path

# (module, page title, one-line blurb for the index)
SECTIONS = [
    ("attpc_engine_tpu", "Package root", "nuclear map singleton, version"),
    (
        "attpc_engine_tpu.kinematics",
        "Kinematics",
        "reaction chains, distributions, the stage-1 pipeline",
    ),
    (
        "attpc_engine_tpu.detector",
        "Detector",
        "config, the stage-2 simulator, writers",
    ),
    (
        "attpc_engine_tpu.nuclear",
        "Nuclear data",
        "masses, gas/solid targets, stopping power",
    ),
    ("attpc_engine_tpu.io", "Kinematics file I/O", "HDF5 writer/reader"),
    ("attpc_engine_tpu.ops", "Ops", "Szudzik pairing"),
    (
        "attpc_engine_tpu.parallel",
        "Parallelism",
        "device meshes, event sharding, multi-host init",
    ),
    ("attpc_engine_tpu.utils", "Utilities", "phase timing, profiler traces"),
    (
        "attpc_engine_tpu.compat",
        "Upstream compatibility",
        "spyral_utils import shim behind the attpc_engine alias package",
    ),
]


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj) -> str:
    doc = inspect.getdoc(obj)
    return doc.strip() if doc else "*No docstring.*"


def _render_function(name: str, obj, level: int) -> list[str]:
    head = "#" * level
    out = [f"{head} `{name}{_signature(obj)}`", ""]
    out += [_doc(obj), ""]
    return out


def _render_class(name: str, obj) -> list[str]:
    out = [f"### `{name}`", ""]
    out += [_doc(obj), ""]
    methods = []
    for mname, member in inspect.getmembers(obj):
        if mname.startswith("_") and mname != "__init__":
            continue
        # only methods defined by this class (not inherited object/protocol
        # plumbing), with their own docstrings
        if not (inspect.isfunction(member) or inspect.ismethod(member)):
            continue
        if mname not in vars(obj):
            continue
        methods.append((mname, member))
    if methods:
        for mname, member in methods:
            shown = name if mname == "__init__" else f"{name}.{mname}"
            sig = _signature(member).replace("(self, ", "(").replace(
                "(self)", "()"
            )
            out += [f"#### `{shown}{sig}`", ""]
            doc = inspect.getdoc(member)
            if mname == "__init__" and (not doc or doc.startswith("Initialize self")):
                continue
            out += [_doc(member), ""]
    return out


def render_module(modname: str, title: str) -> str:
    mod = importlib.import_module(modname)
    lines = [
        f"# {title} (`{modname}`)",
        "",
        "*Generated by `tools/gen_api_docs.py` — do not edit by hand.*",
        "",
    ]
    moddoc = inspect.getdoc(mod)
    if moddoc:
        lines += [moddoc.strip(), ""]
    names = list(getattr(mod, "__all__", []))
    classes = []
    functions = []
    values = []
    for name in names:
        obj = getattr(mod, name)
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif callable(obj):
            functions.append((name, obj))
        else:
            values.append((name, obj))
    if values:
        lines += ["## Module values", ""]
        for name, obj in values:
            r = repr(obj)
            if " object at 0x" in r:  # default repr is not reproducible
                r = f"a {type(obj).__name__} instance"
            lines += [f"- `{name}`: `{type(obj).__name__}` — {r}"[:300], ""]
    if classes:
        lines += ["## Classes", ""]
        for name, obj in classes:
            lines += _render_class(name, obj)
    if functions:
        lines += ["## Functions", ""]
        for name, obj in functions:
            lines += _render_function(name, obj, 3)
    return "\n".join(lines).rstrip() + "\n"


def main() -> None:
    # rendering only needs docstrings/signatures — never touch a device
    import jax

    jax.config.update("jax_platforms", "cpu")
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    outdir = repo / "docs" / "api"
    outdir.mkdir(parents=True, exist_ok=True)
    index = [
        "# API reference",
        "",
        "*Generated by `tools/gen_api_docs.py` — do not edit by hand.*",
        "",
        "Public API of every subpackage, straight from the docstrings.",
        "",
    ]
    for modname, title, blurb in SECTIONS:
        stem = modname.rsplit(".", 1)[-1] if "." in modname else "root"
        page = outdir / f"{stem}.md"
        page.write_text(render_module(modname, title))
        index.append(f"- [{title}]({stem}.md) — {blurb}")
        print(f"wrote {page.relative_to(repo)}")
    (outdir / "index.md").write_text("\n".join(index) + "\n")
    print("wrote docs/api/index.md")


if __name__ == "__main__":
    main()
