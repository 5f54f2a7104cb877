from .efficientnet import EfficientNet, EFFICIENTNET_PARAMS
from .wide_resnet import WideResNet18, WideResNet34
from .pose_predictor import PosePredictor, PosePredictorConfig
from .detector import CenterNetDetector, DetectorConfig, decode_detections
