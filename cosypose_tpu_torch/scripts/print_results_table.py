"""Render README-ready markdown tables from measured results JSONs (port of
cosypose_tpu/scripts/print_results_table.py), on the payloads the port's CLIs
write: run_procedural_accuracy's per-pair table, run_detection_eval's
per-meter summary.

Usage:
    python -m cosypose_tpu_torch.scripts.print_results_table results/<file>.json
    python -m cosypose_tpu_torch.scripts.print_results_table --detection <file>.json
"""

from __future__ import annotations

import argparse
import json


def _mm(v: float) -> str:
    return f"{v * 1000:.1f} mm"


def _pct_drop(v: float, ref: float) -> str:
    if ref <= 0:
        return ""
    return f" ({100.0 * (v - ref) / ref:+.0f}%)"


def per_pair_table(results: dict) -> str:
    """Markdown table of the known-correspondence per-pair ADD protocol
    (init vs refinement iterations) as printed in the README."""
    pp = results["per_pair"]
    init = pp["init"]
    # rotation column only when the arm actually exercises rotation (the
    # trans-only arms start at ~0.006° — a rot column would be noise)
    with_rot = init.get("rot_deg_median", 0.0) > 1.0
    rot_hdr = " rot med |" if with_rot else ""
    lines = [
        f"| | ADD mean | ADD median | p90 |{rot_hdr} dxy | dz | ADD<0.1d |",
        "|---|---|---|---|---|---|---|" + ("---|" if with_rot else ""),
    ]

    def row(name: str, s: dict, with_drop: bool) -> str:
        med = _mm(s["ADD_median"])
        dxy = _mm(s["dxy_mean"])
        rot = f"{s['rot_deg_median']:.1f}°" if with_rot else ""
        if with_drop:
            med += _pct_drop(s["ADD_median"], init["ADD_median"])
            dxy += _pct_drop(s["dxy_mean"], init["dxy_mean"])
            if with_rot:
                rot += _pct_drop(s["rot_deg_median"], init["rot_deg_median"])
        rot_cell = f" {rot} |" if with_rot else ""
        return (
            f"| {name} | {_mm(s['ADD_mean'])} | {med} | {_mm(s['ADD_p90'])} "
            f"|{rot_cell} {dxy} | {_mm(s['dz_mean'])} | "
            f"{s['frac_ADD_lt_0p1d']:.3f} |"
        )

    lines.append(row("init (noisy)", init, with_drop=False))
    for it in range(1, int(results["n_iterations"]) + 1):
        lines.append(row(f"iteration {it}", pp[f"iteration={it}"],
                         with_drop=True))
    if "matched_auc" in results:
        ma = results["matched_auc"]
        lines.append(
            f"\n(matched-AUC protocol on the same run: init "
            f"{ma['init']['AUC']:.3f} → refined {ma['refined']['AUC']:.3f})"
        )
    return "\n".join(lines)


def detection_table(results: dict) -> str:
    """Per-meter summary lines for a run_detection_eval JSON."""
    if "metrics" in results:  # run_detection_eval payload
        lines = []
        for meter, s in results["metrics"].items():
            keys = ("recall", "AP", "mAP", "n_gt", "n_matched")
            parts = [f"{k} {s[k]:.3f}" if isinstance(s.get(k), float)
                     else f"{k} {s[k]}" for k in keys if k in s]
            lines.append(f"{meter}: " + ", ".join(parts))
        return "\n".join(lines)
    s = results.get("summary", results)
    parts = []
    for key in ("recall", "mAP", "AP", "mask_mIoU", "mask_mAP"):
        for k, v in sorted(s.items()):
            if k == key or k.startswith(key + "@"):
                parts.append(f"{k} {v:.3f}" if isinstance(v, float) else
                             f"{k} {v}")
    return ", ".join(parts) if parts else json.dumps(s, indent=2)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("json_path", nargs="+")
    parser.add_argument("--detection", action="store_true",
                        help="render a run_detection_eval summary instead of "
                             "the per-pair accuracy table")
    args = parser.parse_args(argv)
    for path in args.json_path:
        with open(path) as f:
            results = json.load(f)
        header = results.get("run_id", results.get("detector", path))
        ds = results.get("dataset", "")
        print(f"### {header}  ({ds})\n")
        if args.detection or "per_pair" not in results:
            print(detection_table(results))
        else:
            print(per_pair_table(results))
        print()


if __name__ == "__main__":
    main()
