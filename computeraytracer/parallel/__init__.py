from computeraytracer.parallel.mesh import make_mesh  # noqa: F401
from computeraytracer.parallel.render_sharded import (  # noqa: F401
    render_accumulate_sharded,
)
