#!/usr/bin/env python
"""Generate docs/api_reference.md from the package's public surface.

The reference publishes a sphinx ``automodule`` reference over every
module and CLI script (reference docs/modules.rst); this is the
equivalent for this framework: one generated markdown page listing every
public function/class per module with its signature and summary line.
``tests/test_reference_parity.py`` gates freshness, so the page cannot
drift from the code.

Usage::

    python tools/gen_api_reference.py            # rewrite docs/api_reference.md
    python tools/gen_api_reference.py --stdout   # print instead
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
PACKAGE = "configurable_spectrograms_tpu"

#: Root entry-point scripts, in the reference's documentation order
#: (reference docs/modules.rst).
CLI_MODULES = [
    "FAST_CDF_download",
    "batch_multi_plot_spectrogram",
    "batch_multi_plot_FAST_spectrograms",
    "single_plot_spectrogram",
    "single_plot_FAST_spectrograms",
    "single_day_FAST_CDF_download",
    "single_plot_audio_spectrogram",
    "GUI_batch_download_plot_FAST",
]


def iter_package_modules() -> list[str]:
    mods = []
    pkg_dir = os.path.join(REPO, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("__"))
        for fn in sorted(filenames):
            if not fn.endswith(".py") or fn.startswith("_") and fn != "__init__.py":
                continue
            rel = os.path.relpath(os.path.join(dirpath, fn), REPO)
            mod = rel[:-3].replace(os.sep, ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            mods.append(mod)
    return mods


def public_members(mod) -> list[tuple[str, object]]:
    names = getattr(mod, "__all__", None)
    out = []
    for name, obj in inspect.getmembers(mod):
        if name.startswith("_"):
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", None) != mod.__name__ and (
            names is None or name not in names
        ):
            continue  # re-export from elsewhere and not explicitly exported
        out.append((name, obj))
    return sorted(out)


def describe(name: str, obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        sig = "(...)"
    if len(sig) > 80:
        sig = "(" + ", ".join(p for p in inspect.signature(obj).parameters) + ")"
    doc = inspect.getdoc(obj) or ""
    summary = doc.split("\n", 1)[0].strip()
    kind = "class " if inspect.isclass(obj) else ""
    line = f"- `{kind}{name}{sig}`"
    return f"{line} — {summary}" if summary else line


def generate() -> str:
    lines = [
        "# API reference (generated)",
        "",
        "Every public function/class per module, with signature and summary",
        "line.  Regenerate with `python tools/gen_api_reference.py`; gated",
        "for freshness by `tests/test_reference_parity.py`.  The reference's",
        "equivalent is its sphinx module reference (reference",
        "docs/modules.rst).",
        "",
        "## CLI entry points",
        "",
    ]
    for mod_name in CLI_MODULES:
        mod = importlib.import_module(mod_name)
        members = public_members(mod)
        lines.append(f"### `{mod_name}.py`")
        head = (inspect.getdoc(mod) or "").split("\n", 1)[0].strip()
        if head:
            lines.append(f"{head}")
        lines += [describe(n, o) for n, o in members] or ["- (argument parsing only)"]
        lines.append("")
    lines += ["## Library modules", ""]
    for mod_name in iter_package_modules():
        mod = importlib.import_module(mod_name)
        members = public_members(mod)
        if not members:
            continue
        lines.append(f"### `{mod_name}`")
        head = (inspect.getdoc(mod) or "").split("\n", 1)[0].strip()
        if head:
            lines.append(f"{head}")
        lines += [describe(n, o) for n, o in members]
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def main() -> int:
    text = generate()
    if "--stdout" in sys.argv:
        sys.stdout.write(text)
        return 0
    out = os.path.join(REPO, "docs", "api_reference.md")
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out} ({text.count(chr(10))} lines)")
    return 0


if __name__ == "__main__":
    from configurable_spectrograms_tpu.cli.common import clean_exit

    clean_exit(main())
