"""Host-side helpers (port of cosypose_tpu/utils/). Left out:
`PandasTensorCollection`; the port has no pandas, and `TensorCollection`
with dict infos takes its place."""

from .tensor_collection import TensorCollection, concatenate
from .logging import get_logger
from .timer import Timer
