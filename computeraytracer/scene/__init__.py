from computeraytracer.scene.data import Scene, ScenePrimitives, SceneLights, CameraSpec  # noqa: F401
from computeraytracer.scene.loader import load_scene, scene_from_dict  # noqa: F401
