"""The packages that only the renders, plots and t-SNE need (matplotlib,
imageio, scikit-learn), imported when a function first needs them and never
when a module is imported, so the rest of the port runs where they are not
installed. A missing one raises an ``ImportError`` that names it."""

from __future__ import annotations

import importlib

# what a render imports
RENDER_MODULES = ("matplotlib.pyplot", "imageio.v2")
# module -> the package that installs it
PACKAGES = {"matplotlib": "matplotlib", "mpl_toolkits": "matplotlib", "imageio": "imageio",
            "sklearn": "scikit-learn"}


def require(module: str, purpose: str):
    """Import ``module``, or raise naming the package that ``purpose`` needs."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        package = PACKAGES[module.split(".")[0]]
        raise ImportError(f"{purpose} needs the '{package}' package, which is not "
                          "installed") from e


def pyplot(purpose: str = "plotting"):
    """matplotlib's pyplot on the Agg backend (files only, no display)."""
    require("matplotlib", purpose).use("Agg")
    return require("matplotlib.pyplot", purpose)


def imageio(purpose: str = "writing a GIF"):
    return require("imageio.v2", purpose)
