"""Runtime checking (SURVEY.md §5 "Race detection / sanitizers").

The reference's correctness story is by-construction (one thread owns
one pixel, ComputeShader.wgsl:107) with zero runtime checks. Here the
Triton kernel keeps that one-owner-per-ray invariant (no cross-program
writes), and the XLA path gets an opt-in sanitizer built on
``jax.experimental.checkify``: NaN/Inf generation and out-of-bounds
gathers inside the traced computation raise with a source location
instead of silently corrupting the image.

Use it when debugging a scene or a new kernel variant::

    from computeraytracer.utils import debug
    img = debug.checked(lambda s: render_sample(s, 64, 64, 1))(scene)

Not for the hot path — checkify instruments every op it guards. Pass
``use_remat=False`` to the tracer under check: checkify cannot rewrite
through a ``jax.checkpoint``-wrapped scan body (upstream limitation),
and rematerialization is pointless in a debug run anyway.
"""

from __future__ import annotations

import functools


def checked(fn, *, nan: bool = True, oob: bool = True, div: bool = False):
    """Wrap ``fn`` so any NaN (and optionally OOB index / div-by-zero)
    produced while executing it raises ``checkify.JaxRuntimeError``.

    div defaults off: masked-lane math in the tracer legitimately
    divides by zero in lanes whose results are discarded (the same
    pattern the WGSL kernel relies on); NaN checks still fire if such a
    value ever escapes into live state.
    """
    from jax.experimental import checkify

    errors = frozenset()
    if nan:
        errors = errors | checkify.nan_checks
    if oob:
        errors = errors | checkify.index_checks
    if div:
        errors = errors | checkify.div_checks
    checked_fn = checkify.checkify(fn, errors=errors)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = checked_fn(*args, **kwargs)
        err.throw()
        return out

    return wrapper
