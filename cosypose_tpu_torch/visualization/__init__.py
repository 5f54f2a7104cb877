from .dashboard import make_dashboard
from .multiview import nms3d, make_scene_renderings
from .plotter import Plotter
from .singleview import render_prediction_overlay
