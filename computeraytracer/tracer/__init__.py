from computeraytracer.tracer.api import render, render_sample  # noqa: F401
