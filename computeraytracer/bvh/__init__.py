from computeraytracer.bvh.builder import (BVHArrays, auto_bvh, build_bvh,
                                          make_refit, primitive_bounds,
                                          scene_bvh)
from computeraytracer.bvh.traverse import intersect_bvh

__all__ = ["BVHArrays", "auto_bvh", "build_bvh", "make_refit",
           "primitive_bounds", "scene_bvh", "intersect_bvh"]
