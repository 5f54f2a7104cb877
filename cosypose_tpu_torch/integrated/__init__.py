from .pose_predictor import CoarseRefinePosePredictor, LoadedPoseModel
from .multiview_predictor import MultiviewScenePredictor
from .detector import Detector
