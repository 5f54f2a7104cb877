from .record_dataset import record_chunk, record_dataset
from .scene_sampler import RecordingSceneSampler, SceneSamplerError
