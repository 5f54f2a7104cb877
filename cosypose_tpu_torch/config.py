"""Global paths (port of cosypose_tpu/config.py).

The same environment variables as the JAX package, so both packages find the
same data, experiments and results:

    COSYPOSE_TPU_DATA_DIR    datasets root (default ./local_data)
    COSYPOSE_TPU_EXP_DIR     training runs (default <data>/experiments)
    COSYPOSE_TPU_RESULTS_DIR results (default <data>/results)
    COSYPOSE_TPU_DEBUG_DIR   debug dumps (default <data>/debug_data)
"""

from __future__ import annotations

import os
import pathlib

PROJECT_ROOT = pathlib.Path(__file__).resolve().parent.parent

LOCAL_DATA_DIR = pathlib.Path(os.environ.get("COSYPOSE_TPU_DATA_DIR",
                                             PROJECT_ROOT / "local_data"))
EXP_DIR = pathlib.Path(os.environ.get("COSYPOSE_TPU_EXP_DIR", LOCAL_DATA_DIR / "experiments"))
RESULTS_DIR = pathlib.Path(os.environ.get("COSYPOSE_TPU_RESULTS_DIR", LOCAL_DATA_DIR / "results"))
DEBUG_DATA_DIR = pathlib.Path(os.environ.get("COSYPOSE_TPU_DEBUG_DIR", LOCAL_DATA_DIR / "debug_data"))
