"""computeraytracer — a differentiable spectral path tracer for the GPU.

Built from scratch in JAX/XLA and Pallas (Triton) with the capabilities
of the WebGPU compute ray tracer Meryx/ComputeRayTracer (see SURVEY.md):
progressive
hero-wavelength spectral path tracing of JSON scenes (planar patches,
spheres, triangle meshes) with next-event estimation + MIS, diffuse/glass
BSDFs, Beer-Lambert transmission, CIE-XYZ accumulation and sRGB display —
plus the capabilities the reference lacks: BVH acceleration,
differentiability w.r.t. geometry and spectra, multi-device sharding via
jax.sharding, tests, and benchmarks.
"""

__version__ = "0.1.0"

from computeraytracer.config import RenderConfig  # noqa: F401
from computeraytracer.scene.data import Scene  # noqa: F401
