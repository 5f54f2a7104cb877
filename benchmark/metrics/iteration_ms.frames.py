"""Device ms a render-and-compare iteration: CUDA events around each
PosePredictor.forward call, over the iterations it ran."""


def read(run):
    ms, n = run.spans.get("forward"), run.counters.get("iterations")
    return sum(ms) / n if ms and n else None
