"""Former name of the :mod:`krust` package, kept for old imports.

Importing it warns (``DeprecationWarning``). Its attributes are those of
:mod:`krust`, and each submodule imported through it is the :mod:`krust`
module of the same name (one module object, not a copy). ``python -m``
with this name runs the ``kmix`` CLI. Import ``krust`` instead.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import krust as _krust

warnings.warn(
    f"the package name {__name__!r} is deprecated; import 'krust' instead",
    DeprecationWarning,
    stacklevel=2,
)

__version__ = _krust.__version__


def __getattr__(name):
    return getattr(_krust, name)


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this package>.x.y`` to ``krust.x.y``. First on
    ``sys.meta_path``: the path finder would load a second copy of a
    :mod:`krust` file under the old name. ``__main__`` is this
    directory's own."""

    alias_of = __name__

    def __init__(self):
        self._specs = {}

    def find_spec(self, name, path=None, target=None):
        if name.startswith(self.alias_of + ".") and name != self.alias_of + ".__main__":
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        real = importlib.import_module("krust" + spec.name[len(self.alias_of):])
        self._specs[real.__name__] = real.__spec__
        return real

    def exec_module(self, module):
        # the import system stamped the alias spec on the real module
        module.__spec__ = self._specs.pop(module.__name__)


if not any(getattr(f, "alias_of", None) == __name__ for f in sys.meta_path):
    sys.meta_path.insert(0, _Alias())
