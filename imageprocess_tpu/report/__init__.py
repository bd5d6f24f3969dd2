"""Host-side report writers: CSV/XLSX tables, PNG/TIFF image exports,
PPTX decks.  These consume device results; nothing here runs on the device.

``render`` (matplotlib) loads lazily: tables-only pipelines import this
package for the excel writers, and an eager render import would tax every
such run with matplotlib setup.
"""

from . import excel  # noqa: F401


def __getattr__(name):
    if name == "render":
        # importlib (not `from . import`): the fromlist machinery would
        # re-enter this __getattr__ and recurse
        import importlib

        return importlib.import_module(__name__ + ".render")
    raise AttributeError(name)
