"""Sphinx configuration for the eryn_tpu documentation site.

Builds the existing markdown documentation set (tutorial, migration guide,
architecture, API reference) plus autodoc-generated API pages into a
rendered site; published by ``.github/workflows/pages.yml``
(reference parity: ``/root/reference/docs/source/conf.py`` +
``.github/workflows/pages.yml``, re-designed for this tree).
"""

import os
import sys

sys.path.insert(0, os.path.abspath("../.."))

project = "eryn_tpu"
copyright = "2026, eryn_tpu developers"
author = "eryn_tpu developers"
release = "0.1.0"

extensions = [
    "myst_parser",
    "sphinx.ext.autodoc",
    "sphinx.ext.autosummary",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
    "sphinx.ext.intersphinx",
]

myst_enable_extensions = ["colon_fence", "deflist", "dollarmath"]
myst_heading_anchors = 3

source_suffix = {".rst": "restructuredtext", ".md": "markdown"}

templates_path = ["_templates"]
exclude_patterns = []

autodoc_member_order = "bysource"
autodoc_typehints = "description"
autosummary_generate = True

# heavy / optional runtime deps are mocked so the doc build needs only the
# package itself plus jax-on-CPU
autodoc_mock_imports = ["h5py", "matplotlib", "tqdm"]

intersphinx_mapping = {
    "python": ("https://docs.python.org/3", None),
    "numpy": ("https://numpy.org/doc/stable/", None),
    "jax": ("https://docs.jax.dev/en/latest/", None),
}

html_theme = "furo"
html_title = "eryn_tpu — compiled ensemble MCMC in JAX"
html_static_path = []
