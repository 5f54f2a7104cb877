"""Interactive multi-run training dashboard as one self-contained HTML file
(port of cosypose_tpu/visualization/dashboard.py): multi-run curve overlays
with hover tooltips, click-to-hide legends, a log-scale toggle and a
config-diff table, the run data inlined as JSON and drawn into SVG by a
little vanilla JS, so the page opens anywhere with nothing installed.

Run-dir layout read (training/checkpoint.py):
    <run_dir>/config.yaml   the run's config as the port writes it: JSON,
                            which is a subset of YAML (read with json, no
                            yaml module needed; the card's machine has none)
    <run_dir>/log.txt       jsonlines; each record has "epoch" plus metric
                            keys like "train/loss_total", "val/loss_total",
                            "test/<metric>"
"""

import html as html_mod
import json
import pathlib

__all__ = ["load_runs", "make_dashboard", "config_diff"]

# seaborn default palette (hex), same cycle the reference uses for run colors
_PALETTE = ["#4c72b0", "#dd8452", "#55a868", "#c44e52", "#8172b3",
            "#937860", "#da8bc3", "#8c8c8c", "#ccb974", "#64b5cd"]


def load_runs(run_dirs):
    """Read (config, records) for each run dir; missing files -> empty.

    Returns {run_name: {"config": dict, "records": [dict]}}.
    """
    runs = {}
    for run_dir in run_dirs:
        run_dir = pathlib.Path(run_dir)
        cfg_path = run_dir / "config.yaml"
        config = {}
        if cfg_path.exists():
            text = cfg_path.read_text()
            try:
                config = json.loads(text) if text.strip() else {}
            except json.JSONDecodeError as e:
                raise ValueError(f"{cfg_path} is not the JSON config the port writes: {e}") \
                    from None
        records = []
        log_path = run_dir / "log.txt"
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        runs[run_dir.name] = dict(config=config, records=records)
    return runs


def config_diff(runs, ignore=("run_id", "resume")):
    """Rows (key, {run: value}) for config keys that differ across runs."""
    keys = []
    for run in runs.values():
        for k in run["config"]:
            if k not in keys and k not in ignore:
                keys.append(k)
    rows = []
    for k in keys:
        vals = {name: run["config"].get(k) for name, run in runs.items()}
        uniq = {json.dumps(v, sort_keys=True, default=str)
                for v in vals.values()}
        if len(uniq) > 1:
            rows.append((k, vals))
    return rows


def _series(runs, fields):
    """One chart spec per field: [{field, series: [{run, color, x, y}]}]."""
    charts = []
    for field in fields:
        series = []
        for i, (name, run) in enumerate(runs.items()):
            xs, ys = [], []
            for r in run["records"]:
                if field in r and r[field] is not None and "epoch" in r:
                    xs.append(r["epoch"])
                    ys.append(float(r[field]))
            if xs:
                series.append(dict(run=name, color=_PALETTE[i % len(_PALETTE)],
                                   x=xs, y=ys))
        if series:
            charts.append(dict(field=field, series=series))
    return charts


def discover_fields(runs, prefix):
    """All metric keys starting with ``prefix`` seen in any run, in order."""
    fields = []
    for run in runs.values():
        for r in run["records"]:
            for k in r:
                if k.startswith(prefix) and k not in fields:
                    fields.append(k)
    return fields


_JS = """
const esc = s => String(s).replace(/&/g, '&amp;').replace(/</g, '&lt;')
                          .replace(/>/g, '&gt;').replace(/"/g, '&quot;');
function draw(el, chart, logScale) {
  const W = 420, H = 260, L = 52, R = 10, T = 26, B = 30;
  const vis = chart.series.filter(s => !s.hidden);
  let xs = [], ys = [];
  vis.forEach(s => { xs = xs.concat(s.x); ys = ys.concat(s.y); });
  if (!xs.length) { el.innerHTML = '<svg width="420" height="260"></svg>'; return; }
  const tf = logScale ? (v => Math.log10(Math.max(v, 1e-12))) : (v => v);
  ys = ys.map(tf);
  const x0 = Math.min(...xs), x1 = Math.max(...xs) || 1;
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const sx = v => L + (v - x0) / Math.max(x1 - x0, 1e-12) * (W - L - R);
  const sy = v => H - B - (tf(v) - y0) / Math.max(y1 - y0, 1e-12) * (H - T - B);
  let g = `<svg width="${W}" height="${H}">`;
  g += `<text x="${L}" y="14" class="t">${esc(chart.field)}</text>`;
  for (let i = 0; i <= 4; i++) {
    const yy = T + i * (H - T - B) / 4;
    const val = logScale ? Math.pow(10, y1 - i * (y1 - y0) / 4)
                         : y1 - i * (y1 - y0) / 4;
    g += `<line x1="${L}" y1="${yy}" x2="${W - R}" y2="${yy}" class="grid"/>`;
    g += `<text x="${L - 4}" y="${yy + 3}" class="ax" text-anchor="end">${val.toPrecision(3)}</text>`;
  }
  g += `<text x="${(L + W - R) / 2}" y="${H - 8}" class="ax" text-anchor="middle">epoch</text>`;
  vis.forEach(s => {
    const pts = s.x.map((x, i) => `${sx(x).toFixed(1)},${sy(s.y[i]).toFixed(1)}`).join(' ');
    g += `<polyline points="${pts}" fill="none" stroke="${s.color}" stroke-width="1.4"/>`;
  });
  g += `<circle class="hov" r="3" fill="none" stroke="#222" visibility="hidden"/>`;
  g += `<text class="hovt ax" visibility="hidden"></text></svg>`;
  el.innerHTML = g;
  const svg = el.firstChild, hov = svg.querySelector('.hov'),
        hovt = svg.querySelector('.hovt');
  svg.addEventListener('mousemove', ev => {
    const r = svg.getBoundingClientRect();
    const mx = ev.clientX - r.left, my = ev.clientY - r.top;
    let best = null, bd = 400;
    vis.forEach(s => s.x.forEach((x, i) => {
      const d = (sx(x) - mx) ** 2 + (sy(s.y[i]) - my) ** 2;
      if (d < bd) { bd = d; best = [s, i]; }
    }));
    if (!best) { hov.setAttribute('visibility', 'hidden');
                 hovt.setAttribute('visibility', 'hidden'); return; }
    const [s, i] = best, px = sx(s.x[i]), py = sy(s.y[i]);
    hov.setAttribute('cx', px); hov.setAttribute('cy', py);
    hov.setAttribute('visibility', 'visible');
    hovt.textContent = `${s.run} ep${s.x[i]}: ${s.y[i].toPrecision(5)}`;
    hovt.setAttribute('x', Math.min(px + 6, 220));
    hovt.setAttribute('y', Math.max(py - 6, 22));
    hovt.setAttribute('visibility', 'visible');
  });
}
function render() {
  const logScale = document.getElementById('logscale').checked;
  document.querySelectorAll('.chart').forEach((el, i) => draw(el, DATA.charts[i], logScale));
  const leg = document.getElementById('legend');
  leg.innerHTML = DATA.runs.map((r, i) =>
    `<span class="lg" data-run="${esc(r)}" style="text-decoration:${HIDDEN.has(r) ? 'line-through' : 'none'}">` +
    `<span class="sw" style="background:${DATA.palette[i % DATA.palette.length]}"></span>${esc(r)}</span>`).join('');
  leg.querySelectorAll('.lg').forEach(el => el.addEventListener('click', () => {
    const r = el.dataset.run;
    HIDDEN.has(r) ? HIDDEN.delete(r) : HIDDEN.add(r);
    DATA.charts.forEach(c => c.series.forEach(s => { s.hidden = HIDDEN.has(s.run); }));
    render();
  }));
}
const HIDDEN = new Set();
window.addEventListener('load', render);
"""

_CSS = """
body { font: 12px sans-serif; margin: 16px; background: #fff; color: #222; }
.chart { display: inline-block; margin: 4px; background: #eaeaf2; border-radius: 4px; }
.grid { stroke: #fff; stroke-width: 1; }
.ax { font: 9px sans-serif; fill: #444; }
.t { font: 11px sans-serif; font-weight: bold; fill: #222; }
.lg { margin-right: 14px; cursor: pointer; user-select: none; }
.sw { display: inline-block; width: 10px; height: 10px; margin-right: 4px; }
table { border-collapse: collapse; margin-top: 12px; }
td, th { border: 1px solid #ccc; padding: 2px 8px; font: 11px monospace; }
"""


def make_dashboard(run_dirs, out_path, train_fields=None, eval_fields=None):
    """Write the self-contained HTML dashboard; returns the output path.

    ``train_fields``/``eval_fields`` default to every ``train/``+``val/`` and
    ``eval/`` metric found in the logs.
    """
    runs = load_runs(run_dirs)
    if train_fields is None:
        train_fields = (discover_fields(runs, "train/")
                        + discover_fields(runs, "val/"))
    if eval_fields is None:
        eval_fields = discover_fields(runs, "eval/")
    charts = _series(runs, list(train_fields) + list(eval_fields))
    data = dict(runs=list(runs), palette=_PALETTE, charts=charts)

    diff_rows = config_diff(runs)
    names = list(runs)
    # run names / config values come from the filesystem and user configs:
    # escape them so '<', '&', quotes can't break or inject into the page
    e = html_mod.escape
    table = ["<tr><th>config key</th>"
             + "".join(f"<th>{e(str(n))}</th>" for n in names) + "</tr>"]
    for key, vals in diff_rows:
        table.append(f"<tr><td>{e(str(key))}</td>" + "".join(
            f"<td>{e(str(vals[n]))}</td>" for n in names) + "</tr>")

    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>cosypose_tpu runs</title><style>{_CSS}</style></head><body>
<h2>cosypose_tpu training dashboard</h2>
<label><input type="checkbox" id="logscale" onchange="render()"> log scale</label>
<div id="legend"></div>
<div>{"".join('<div class="chart"></div>' for _ in charts)}</div>
<h3>config diff</h3><table>{"".join(table)}</table>
<script>const DATA = {json.dumps(data).replace("</", "<\\/")};{_JS}</script></body></html>"""

    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(html)
    return out_path
