"""Faults planted under a cell's timed path, to show that its check catches
them: each breaks the program after set-up and before the first request or
step. A `frames` fault takes the server; a `train_items` fault takes the
train state and the step function and returns the step function to run.
"""

from __future__ import annotations


def _forward_patch(server, change):
    """Wrap each model's PosePredictor.forward with change(inputs, outputs)."""
    for model in (server.coarse_model, server.refiner_model):
        pp = model.predictor
        inner = pp.forward

        def forward(mesh_data, images, K, TCO_init, n_iterations=1, inner=inner):
            out = inner(mesh_data, images, K, TCO_init, n_iterations)
            return change(TCO_init, {k: v.clone() for k, v in out.items()})

        pp.forward = forward


def frames_state_unchanged(server):
    """Every iteration returns the pose it was given."""
    def change(T, out):
        out["TCO_output"] = out["TCO_input"].clone()
        out["TCO_final"] = T
        return out

    _forward_patch(server, change)


def frames_half_batch(server):
    """The second half of each request's detections keeps the poses it came
    in with, at every iteration of both models."""
    inner = server.batched_model_predictions

    def predictions(model, images, K, obj_data, n_iterations=1):
        preds = inner(model, images, K, obj_data, n_iterations)
        half = len(obj_data) // 2
        for p in preds.values():
            p.poses = p.poses.clone()
            p.poses[half:] = p.poses_input[half:]
        return preds

    server.batched_model_predictions = predictions


def frames_answer_altered(server):
    """The first row's pose moves 1 cm along x where the last iteration
    produces it."""
    def change(T, out):
        out["TCO_output"][-1, 0, 0, 3] += 0.01
        out["TCO_final"] = out["TCO_output"][-1]
        return out

    _forward_patch(server, change)


def frames_refiner_from_init(server):
    """The refiner starts from the box-seeded init in place of the coarse
    model's poses."""
    inner = server.batched_model_predictions
    init = {}

    def predictions(model, images, K, obj_data, n_iterations=1):
        if model is server.coarse_model:
            init["poses"] = obj_data
        elif "poses" in init:
            obj_data = init.pop("poses")
        return inner(model, images, K, obj_data, n_iterations)

    server.batched_model_predictions = predictions


def train_items_state_unchanged(state, step_fn):
    """The optimizer's step does nothing."""
    state.optimizer.step = lambda *a, **k: None
    return step_fn


def train_items_half_batch(state, step_fn):
    """The step sees the first half of the batch alone: its loss is the
    mean over that half."""
    def half(st, batch, draws):
        h = batch["images"].shape[0] // 2
        rows = {k: v[:h] for k, v in batch.items()}
        d = dict(draws, pose_noise=tuple(t[:h] for t in draws["pose_noise"]),
                 drop_masks=[[None if m is None else m[:h] for m in it]
                             for it in draws["drop_masks"]])
        return step_fn(st, rows, d)

    return half


def train_items_answer_altered(state, step_fn):
    """One sample's rotation noise is doubled where the step's input poses
    are drawn."""
    def altered(st, batch, draws):
        eu, tr = (t.clone() for t in draws["pose_noise"])
        eu[0] *= 2
        return step_fn(st, batch, dict(draws, pose_noise=(eu, tr)))

    return altered


FAULTS = {"frames": ("state_unchanged", "half_batch", "answer_altered", "refiner_from_init"),
          "train_items": ("state_unchanged", "half_batch", "answer_altered")}


def get(kind: str, name: str):
    """The fault `name` for mixes of `kind`."""
    if name not in FAULTS.get(kind, ()):
        raise KeyError(f"no fault {name!r} for {kind!r} mixes: {FAULTS.get(kind)}")
    return globals()[f"{kind}_{name}"]
