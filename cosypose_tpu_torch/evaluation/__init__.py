"""Evaluation (port of cosypose_tpu/evaluation/): pose and detection meters,
BOP19 Average Recall, the evaluation and prediction runners, BOP CSV export
and the in-training evaluation bundle."""
