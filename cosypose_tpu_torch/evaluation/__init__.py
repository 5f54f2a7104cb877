"""Evaluation (port of cosypose_tpu/evaluation/): pose and detection meters,
BOP19 Average Recall, the evaluation and prediction runners, BOP CSV export
and the in-training evaluation bundle."""

from .meters import PoseErrorMeter, DetectionMeter, compute_auc_posecnn
from .runner_utils import run_pred_eval, format_results
from .bop_export import predictions_to_bop_csv
from .pred_runners import (
    MultiviewPredictionRunner,
    BopPredictionRunner,
    DetectionRunner,
)
from .eval_runners import PoseEvaluation, DetectionEvaluation
from .data_utils import parse_obs_data
