"""Sphinx configuration for the spectrogram engine docs.

The documentation sources are the Markdown files in this directory
(architecture, parity, budget, deployment, API reference), parsed with
MyST.  Counterpart of the reference's Sphinx setup
(reference docs/conf.py:1); where the reference autodocs its package,
this site ships the generated API reference (docs/api_reference.md,
produced by tools/gen_api_reference.py) plus the design documents.

Offline images without Sphinx can build the same site with the
zero-dependency fallback: ``python tools/build_docs.py``.
"""

import os
import sys
from datetime import datetime, timezone

sys.path.insert(0, os.path.abspath(".."))

project = "Configurable Spectrograms"
author = "configurable-spectrograms contributors"
copyright = f"{datetime.now(timezone.utc).year}, {author}"

extensions = [
    "myst_parser",
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]

source_suffix = {".md": "markdown", ".rst": "restructuredtext"}
master_doc = "index"
exclude_patterns = ["_build"]
html_theme = "alabaster"
myst_enable_extensions = ["tasklist", "deflist"]
