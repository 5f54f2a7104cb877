from .scene_renderer import BatchRenderer, SceneRenderer
