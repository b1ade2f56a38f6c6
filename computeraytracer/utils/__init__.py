from computeraytracer.utils.image import write_png  # noqa: F401
from computeraytracer.utils.metrics import RenderMeter  # noqa: F401
