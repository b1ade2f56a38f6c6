"""The package's former import name, kept as an alias of
`computeraytracer`.

Importing it imports every Python module of computeraytracer and
registers each under this name too, so `import <this name>.tracer.api`
and `python -m <this name> render ...` reach the same module objects as
the new name. New code imports computeraytracer.
"""

import importlib
import pkgutil
import sys

import computeraytracer as _pkg

_prefix = _pkg.__name__ + "."
for _info in pkgutil.walk_packages(_pkg.__path__, _prefix):
    _leaf = _info.name.rsplit(".", 1)[-1]
    _spec = _info.module_finder.find_spec(_info.name)
    if _leaf != "__main__" and _spec.origin.endswith(".py"):
        sys.modules[__name__ + "." + _info.name[len(_prefix):]] = (
            importlib.import_module(_info.name))
sys.modules[__name__] = _pkg
