"""Share of the rows run through PosePredictor.forward (rows x iterations,
counted by the harness's wrapper) that were no detection: the padding of
CoarseRefinePosePredictor's fixed-size chunks."""


def read(run):
    rows = run.counters.get("rows")
    if not rows:
        return None
    return 100.0 * (1.0 - run.totals["useful_rows"] / rows)
