# NOTE: no function re-exports here — `optimize` must stay importable as
# a submodule (computeraytracer.train.optimize).
from computeraytracer.train import checkpoint, optimize  # noqa: F401
