"""The port's training loop on the CPU, after tests/test_train_pose.py: two
epochs of train_pose over the in-memory demo dataset (log lines, config,
checkpoints kept two at a time, resume, pretrain, validation, the eval hook),
the loader against the JAX package's PrefetchLoader, the checkpoint round
trip, and the train forward's gradient boundaries. Tiny sizes: EfficientNet-B0,
48×64 renders, batch 2, the demo spheres at 64 render faces.
"""

import json

import numpy as np
import pytest
import torch

from cosypose_tpu.data.pose_dataset import PoseDataset as JPoseDataset
from cosypose_tpu.data.wrappers import PartialSampler as JPartialSampler
from cosypose_tpu.training.train_pose import PrefetchLoader
from cosypose_tpu_torch import demo
from cosypose_tpu_torch.data.wrappers import PartialSampler
from cosypose_tpu_torch.models.pose_predictor import PosePredictorConfig, gather_mesh_data
from cosypose_tpu_torch.ops.mesh_db import build_mesh_db
from cosypose_tpu_torch.ops.render import render
from cosypose_tpu_torch.training import pose_training as tpt
from cosypose_tpu_torch.training.checkpoint import (latest_checkpoint, load_checkpoint,
                                                    restore_into_state, save_checkpoint)
from cosypose_tpu_torch.training.configs import RunConfig
from cosypose_tpu_torch.training.train_pose import ConcatDataset, make_loader, train_pose

IMAGE = (96, 128)



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The fast tier runs several test processes side by side on the CPU's
    cores; PyTorch's own thread pool in each would oversubscribe them and
    slow every process many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def tiny_cfg(run_id="run", n_epochs=2, **kw):
    tcfg = tpt.PoseTrainConfig(
        predictor=PosePredictorConfig(backbone="efficientnet-b0", render_size=(48, 64),
                                      n_points_crop=64),
        n_iterations=1, n_points_loss=100, input_generator="gt+noise", batch_size=2,
        epoch_size=4, n_epochs=n_epochs, n_epochs_warmup=1, **kw)
    return RunConfig(run_id=run_id, train=tcfg, n_dataloader_workers=0, val_epoch_interval=1)


@pytest.fixture(scope="module")
def world():
    return (build_mesh_db(demo.demo_specs(), render_max_faces=64, device="cpu"),
            demo.DemoPoseDataset(6, IMAGE, seed=0))


def test_demo_pose_dataset_items(world):
    _, ds = world
    assert len(ds) == 6
    it = ds[3]
    assert it["image"].shape == (3, *IMAGE) and it["image"].dtype == np.uint8
    assert it["K"].shape == (3, 3) and it["TCO"].shape == (4, 4) and it["bbox"].shape == (4,)
    spec = {s.label: s for s in demo.demo_specs()}[it["label"]]
    pts = spec.vertices * 0.001 @ it["TCO"][:3, :3].T + it["TCO"][:3, 3]
    uv = (pts @ it["K"].T)[:, :2] / (pts @ it["K"].T)[:, 2:]
    np.testing.assert_allclose(it["bbox"], [*uv.min(0), *uv.max(0)], rtol=1e-5)
    again = demo.DemoPoseDataset(6, IMAGE, seed=0)[3]
    assert all(np.array_equal(it[k], again[k]) for k in ("image", "K", "TCO", "bbox"))


def test_train_pose_two_epochs_logs_and_checkpoints(world, tmp_path):
    db, ds = world
    calls = []
    state, run_dir = train_pose(tiny_cfg(n_epochs=3), {"train": [(ds, 1)], "val": [(ds, 1)]}, db,
                                exp_dir=tmp_path, device="cpu",
                                eval_callback=lambda s, e: calls.append(e) or {"dummy": e})
    assert state.step == 3 * 2  # 3 epochs of 4 samples in batches of 2
    assert (run_dir / "config.yaml").exists()
    assert json.loads((run_dir / "config.yaml").read_text())["train"]["predictor"][
        "compute_dtype"] == "torch.float32"
    recs = [json.loads(line) for line in (run_dir / "log.txt").read_text().splitlines()]
    train_recs = [r for r in recs if "train/loss_total" in r]
    assert [r["epoch"] for r in train_recs] == [0, 1, 2]
    for r in train_recs:
        assert np.isfinite(r["train/loss_total"]) and r["train/grad_norm"] > 0
        assert r["train/step_s_per_step"] > 0 and r["train/data_s_per_step"] >= 0
        # two steps an epoch: the mean holds the first wait and the later half's
        assert r["train/data_s_per_step"] == pytest.approx(
            (r["train/data_s_first_batch"] + r["train/data_s_second_half"]) / 2)
        assert "train/loss_TCO-iter=1" in r and "train/loss_orn" in r
    assert sum("val/loss_total" in r for r in recs) == 3
    assert calls == [0, 2]  # test_epoch_interval 30: epoch 0 and the last
    assert any("test/dummy" in r for r in recs)
    ckpts = sorted(p.name for p in (run_dir / "checkpoint").iterdir())
    assert ckpts == ["epoch_00001.pt", "epoch_00002.pt"]  # keep 2
    payload = load_checkpoint(latest_checkpoint(run_dir))
    assert payload["epoch"] == 2 and payload["step"] == 6


def test_resume_restores_the_whole_state(world, tmp_path):
    db, ds = world
    data = {"train": [(ds, 1)]}
    state, run_dir = train_pose(tiny_cfg(), data, db, exp_dir=tmp_path, device="cpu")
    resumed, _ = train_pose(tiny_cfg(), data, db, exp_dir=tmp_path, device="cpu", resume=True)
    assert resumed.step == state.step == 4
    for (n, a), b in zip(state.pp.net.state_dict().items(), resumed.pp.net.state_dict().values()):
        assert torch.equal(a, b), n
    for p, q in zip(state.pp.net.parameters(), resumed.pp.net.parameters()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.state[p][k], resumed.optimizer.state[q][k]), k
    more, _ = train_pose(tiny_cfg(n_epochs=3), data, db, exp_dir=tmp_path, device="cpu",
                         resume=True)
    assert more.step == 6
    epochs = [json.loads(line)["epoch"] for line in (run_dir / "log.txt").read_text().splitlines()]
    assert epochs == [0, 1, 2]


def test_pretrain_loads_weights_and_starts_afresh(world, tmp_path):
    db, ds = world
    data = {"train": [(ds, 1)]}
    pre, _ = train_pose(tiny_cfg("pre"), data, db, exp_dir=tmp_path, device="cpu")
    cfg = tiny_cfg("post", n_epochs=1)
    post, run_dir = train_pose(cfg, data, db, exp_dir=tmp_path, device="cpu",
                               pretrain_run_id="pre")
    assert post.step == 2  # the optimizer and the step start afresh
    # two Adam steps move each parameter by at most ~2 lr from the pretrained one
    for a, b in zip(pre.pp.net.parameters(), post.pp.net.parameters()):
        assert float((a - b).detach().abs().max()) <= 2 * cfg.train.lr * 1.01
    with pytest.raises(FileNotFoundError):
        train_pose(tiny_cfg("x"), data, db, exp_dir=tmp_path, device="cpu",
                   pretrain_run_id="missing")


def test_checkpoint_round_trip(world, tmp_path):
    db, ds = world
    cfg = tiny_cfg().train
    state = tpt.create_train_state(cfg, "cpu")
    step = tpt.make_train_step(cfg, db)
    batch = next(iter(make_loader(ds, PartialSampler(ds, 4, 0), 2, 0, False)))
    batch = dict(images=batch["images"], K=batch["K"], TCO=batch["TCO"],
                 bboxes=batch["bboxes"], label_ids=db.ids_for(batch["labels"]))
    step(state, batch, tpt.draw_step(cfg, state.pp, 2, db.points.shape[1],
                                     torch.Generator().manual_seed(0)))
    for epoch in range(4):
        path = save_checkpoint(tmp_path, state, epoch)
    assert sorted(p.name for p in path.parent.iterdir()) == ["epoch_00002.pt", "epoch_00003.pt"]
    fresh = tpt.create_train_state(cfg, "cpu", torch.Generator().manual_seed(5))
    restore_into_state(fresh, load_checkpoint(latest_checkpoint(tmp_path)))
    assert fresh.step == 1
    for a, b in zip(state.pp.net.state_dict().values(), fresh.pp.net.state_dict().values()):
        assert torch.equal(a, b)
    p, q = next(state.pp.net.parameters()), next(fresh.pp.net.parameters())
    assert torch.equal(state.optimizer.state[p]["exp_avg"], fresh.optimizer.state[q]["exp_avg"])


def test_loader_follows_the_jax_batches(world):
    """Same sampler order, same full batches, same arrays as the JAX
    package's PrefetchLoader (one worker, so its batches stay in order)."""
    _, ds = world
    both = ConcatDataset([(ds, 2)])
    ref = PrefetchLoader(both, JPartialSampler(both, 10, seed=3), 4, JPoseDataset.collate_fn,
                         n_workers=1)
    port = make_loader(both, PartialSampler(both, 10, seed=3), 4, 0, False)
    # iterate as the training loops do: list() would first ask the JAX
    # loader for its length, which draws one permutation from the sampler
    ref, port = [b for b in ref], [b for b in port]
    assert len(ref) == len(port) == 2  # 10 samples, batches of 4, the rest dropped
    for r, p in zip(ref, port):
        assert r.labels == p["labels"]
        np.testing.assert_array_equal(r.images, p["images"].numpy())
        np.testing.assert_array_equal(r.bboxes, p["bboxes"].numpy())
    with pytest.raises(ValueError):
        make_loader(both, PartialSampler(both, 3, seed=0), 4, 0, False)


def one_batch(db, ds, B=2):
    items = [ds[i] for i in range(B)]
    return dict(images=torch.as_tensor(np.stack([it["image"] for it in items])),
                K=torch.as_tensor(np.stack([it["K"] for it in items])),
                TCO=torch.as_tensor(np.stack([it["TCO"] for it in items])),
                bboxes=torch.as_tensor(np.stack([it["bbox"] for it in items])),
                label_ids=db.ids_for([it["label"] for it in items]))


def test_uint8_images_become_float_in_the_step(world):
    db, ds = world
    cfg = tiny_cfg().train
    state = tpt.create_train_state(cfg, "cpu")
    batch = one_batch(db, ds)
    draws = tpt.draw_step(cfg, state.pp, 2, db.points.shape[1], torch.Generator().manual_seed(0))
    val = tpt.make_val_step(cfg, db)
    a = val(state, batch, draws)
    b = val(state, dict(batch, images=batch["images"].float() / 255.0), draws)
    assert a["loss_total"] == b["loss_total"]


def test_val_step_moves_nothing(world):
    db, ds = world
    cfg = tiny_cfg(rgb_aug_device=True).train
    state = tpt.create_train_state(cfg, "cpu")
    before = {k: v.clone() for k, v in state.pp.net.state_dict().items()}
    draws = tpt.draw_step(cfg, state.pp, 2, db.points.shape[1], torch.Generator().manual_seed(0))
    assert draws["jitter"] is not None
    metrics = tpt.make_val_step(cfg, db)(state, one_batch(db, ds), draws)
    assert np.isfinite(float(metrics["loss_total"])) and state.step == 0
    for k, v in state.pp.net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_train_forward_gradient_boundaries(world):
    """The pose and the crop intrinsics are detached between iterations, the
    net's outputs carry the gradient, and render refuses a gradient."""
    db, ds = world
    cfg = tiny_cfg().train
    state = tpt.create_train_state(cfg, "cpu")
    b = one_batch(db, ds)
    md = gather_mesh_data(db, b["label_ids"], 64)
    outs = state.pp.forward_train(md, b["images"].float() / 255, b["K"], b["TCO"],
                                  n_iterations=2)
    assert outs["pose_outputs"].requires_grad and outs["TCO_output"].requires_grad
    assert not outs["TCO_input"][1].requires_grad and not outs["K_crop"].requires_grad
    assert torch.equal(outs["TCO_input"][1], outs["TCO_output"][0].detach())
    with pytest.raises(ValueError, match="no gradient"):
        render(md["tri_verts"], md["tri_valid"], outs["TCO_output"][0], outs["K_crop"][0],
               image_size=(48, 64), colors=md["tri_colors"])


def test_lr_follows_the_schedule_per_update(world):
    """optax evaluates the schedule at the count of updates before the
    current one: the first update uses schedule(0)."""
    db, ds = world
    cfg = tiny_cfg().train
    cfg = tpt.PoseTrainConfig(**{**cfg.__dict__, "n_epochs_warmup": 3})
    state = tpt.create_train_state(cfg, "cpu")
    step = tpt.make_train_step(cfg, db)
    schedule = tpt.lr_schedule(cfg)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        step(state, one_batch(db, ds), tpt.draw_step(cfg, state.pp, 2, db.points.shape[1], gen))
        assert state.optimizer.param_groups[0]["lr"] == schedule(i)
    assert schedule(0) < schedule(1) < schedule(2) <= cfg.lr
