"""Sync README tables with their tracked results JSONs — or fail on drift
(port of cosypose_tpu/scripts/render_readme_tables.py).

The README's accuracy and detection numbers must be regenerable from tracked
``results/*.json`` artifacts. Every rendered block in README.md is delimited
by

    <!-- rendered-from: <json-path> <kind> -->
    ...rendered content...
    <!-- /rendered-from -->

where <kind> is ``per_pair`` (run_procedural_accuracy payload),
``detection`` (run_detection_eval payload) or ``bop19_ar`` (run_bop_inference
metrics payload). Running the tool re-renders each block from its JSON:

    python -m cosypose_tpu_torch.scripts.render_readme_tables           # rewrite
    python -m cosypose_tpu_torch.scripts.render_readme_tables --check   # fail on drift
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

from .print_results_table import detection_table, per_pair_table

_BLOCK = re.compile(
    r"<!-- rendered-from: (?P<path>\S+) (?P<kind>\w+) -->\n"
    r"(?P<body>.*?)"
    r"<!-- /rendered-from -->",
    re.DOTALL,
)


def bop19_ar_table(results: dict) -> str:
    """One-row markdown table for a run_bop_inference metrics JSON."""
    ar = results["metrics"]["bop19_ar"]
    label = {
        "pose": "det → coarse → refiner",
        "icp": "det → coarse → refiner → ICP(depth)",
        "multiview": "det → coarse → refiner → multiview",
    }.get(ar.get("prediction_key", "pose"), ar.get("prediction_key"))
    return (
        "| pipeline | AR | AR_vsd | AR_mssd | AR_mspd | n_gt |\n"
        "|---|---|---|---|---|---|\n"
        f"| {label} ({results['n_frames']} frames) "
        f"| **{ar['AR']:.3f}** | {ar['AR_vsd']:.3f} | {ar['AR_mssd']:.3f} "
        f"| {ar['AR_mspd']:.3f} | {ar['n_gt']:.0f} |"
    )


def multiview_table(results: dict) -> str:
    """Steady-state row for a bench_multiview JSON (last rep = warm).

    Renders bench_multiview JSONs (a 'backend' field labels the row)."""
    cfg = results["config"]
    r = results["rows"][-1]
    backend = results.get("backend", "this framework")
    return (
        "| implementation | scenario | candidates | matched "
        "| RANSAC (models/score/total) | BA | objects out |\n"
        "|---|---|---|---|---|---|---|\n"
        f"| {backend} "
        f"| {cfg['n_views']} views · {cfg['n_objects']} objects · "
        f"{cfg['ransac_iter']} hypotheses "
        f"| {r['n_candidates']} | {r['n_matched']} "
        f"| {r['ransac_models_s']*1e3:.0f} / {r['ransac_score_s']*1e3:.0f} / "
        f"**{r['ransac_total_s']*1e3:.0f} ms** "
        f"| **{r['ba_total_s']*1e3:.0f} ms** ({cfg['ba_iter']} LM iters, "
        f"{r['n_groups']} group(s)) | {r['n_objects_out']} |"
    )


def step_breakdown_table(results: dict) -> str:
    """Training step breakdown row (scripts/collect_step_breakdown.py)."""
    ips = results["img_per_s_per_chip"]
    ref = results["ref_img_per_s_per_v100"]
    return (
        "| run | batch | data wait /step | end-to-end /step "
        "| img/s/chip | vs ref 70 img/s/V100 |\n"
        "|---|---|---|---|---|---|\n"
        f"| `{results['run_id']}` | {results['batch_size']} "
        f"| {results['data_s_per_step']['median']*1e3:.1f} ms "
        f"| {results['step_s_per_step']['median']*1e3:.0f} ms "
        f"(best {results['step_s_per_step']['min']*1e3:.0f} ms) "
        f"| **{ips['median']:.0f}** (best {ips['best']:.0f}) "
        f"| **{ips['median']/ref:.1f}×** |"
    )


_RENDERERS = {
    "per_pair": per_pair_table,
    "detection": detection_table,
    "bop19_ar": bop19_ar_table,
    "multiview": multiview_table,
    "step_breakdown": step_breakdown_table,
}


def render_blocks(readme_text: str, repo_root: pathlib.Path,
                  check: bool = False):
    """Returns (new_text, drifted: list[str], missing: list[str])."""
    drifted, missing = [], []

    def _sub(m: re.Match) -> str:
        path = repo_root / m.group("path")
        kind = m.group("kind")
        if kind not in _RENDERERS:
            raise ValueError(f"unknown rendered-from kind {kind!r}")
        if not path.exists():
            missing.append(m.group("path"))
            return m.group(0)
        with open(path) as f:
            results = json.load(f)
        body = _RENDERERS[kind](results).rstrip("\n") + "\n"
        if body != m.group("body"):
            drifted.append(m.group("path"))
        return (f"<!-- rendered-from: {m.group('path')} {kind} -->\n"
                f"{body}<!-- /rendered-from -->")

    new_text = _BLOCK.sub(_sub, readme_text)
    return new_text, drifted, missing


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--check", action="store_true",
                        help="fail (exit 1) if any block is stale instead of "
                             "rewriting it")
    parser.add_argument("--readme", default=None)
    args = parser.parse_args(argv)

    repo_root = pathlib.Path(__file__).resolve().parents[2]
    readme = pathlib.Path(args.readme or repo_root / "README.md")
    text = readme.read_text()
    new_text, drifted, missing = render_blocks(text, repo_root,
                                               check=args.check)
    for p in missing:
        print(f"[render_readme_tables] artifact missing, block kept: {p}",
              file=sys.stderr)
    if args.check:
        if drifted:
            print(f"README tables stale vs artifacts: {drifted} — run "
                  "python -m cosypose_tpu_torch.scripts.render_readme_tables",
                  file=sys.stderr)
            return 1
        print(f"README tables in sync ({len(_BLOCK.findall(text))} blocks)")
        return 0
    if new_text != text:
        readme.write_text(new_text)
        print(f"rewrote {len(drifted)} block(s): {drifted}")
    else:
        print("README already in sync")
    return 0


if __name__ == "__main__":
    sys.exit(main())
