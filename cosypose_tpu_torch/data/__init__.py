from .bop import BOPDataset, BOPObjectDataset
from .pose_dataset import PoseDataset, PoseBatch
from .detection_dataset import DetectionDataset
from .augmentations import (
    CropResizeToAspect,
    ColorJitterAugmentation,
    BackgroundAugmentation,
)
from .datasets_cfg import make_scene_dataset, make_object_dataset
