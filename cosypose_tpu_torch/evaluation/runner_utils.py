"""Evaluation orchestration (port of cosypose_tpu/evaluation/runner_utils.py):
every meter sees every prediction key; the result carries the summary, a
printable table, the meters' tables and the raw predictions."""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def run_pred_eval(pred_runner, pred_kwargs, eval_runner, eval_preds=None):
    all_predictions = {}
    for pred_prefix, pred_kwargs_n in pred_kwargs.items():
        for preds_name, preds_n in pred_runner.get_predictions(**pred_kwargs_n).items():
            all_predictions[f"{pred_prefix}/{preds_name}"] = preds_n
    eval_metrics, eval_dfs = {}, {}
    if eval_runner is not None:
        for preds_k, preds in all_predictions.items():
            if eval_preds is None or preds_k in eval_preds:
                eval_metrics[preds_k], eval_dfs[preds_k] = eval_runner.evaluate(preds)
    return format_results(all_predictions, eval_metrics, eval_dfs)


def format_results(predictions, eval_metrics, eval_dfs, print_metrics=True):
    summary, txt = {}, []
    for k, metrics in eval_metrics.items():
        txt.append(f"\n{k}")
        for k_, v in metrics.items():
            summary[f"{k}/{k_}"] = v
            txt.append(f"  {k_}: {v}")
    summary_txt = "\n".join(txt)
    if print_metrics:
        logger.info(summary_txt)
    return dict(summary=summary, summary_txt=summary_txt, predictions=predictions,
                metrics=eval_metrics, dfs=eval_dfs)


def gather_predictions(all_predictions):
    """One process: every prediction is already here."""
    return all_predictions
