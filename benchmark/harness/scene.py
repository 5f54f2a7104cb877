"""What a configuration holds besides its sizes: the object meshes and the
network weights, both made from seeds by the benchmark and handed alike to
the program and to the plain reference.

Meshes: closed superellipsoids with two-tone vertex albedo (a frozen copy of
the procedural object generator the port's demo uses for meshes of 8,192
faces), in millimetres, fixed by the configuration's `mesh_seed`.

Weights: every convolution lecun-normal and the head normal, all drawn on the
device in one call from the run's seed; BatchNorm's running statistics set
from the batch statistics of one train-mode pass of the plain network over
network inputs of the cell's own kind (seeded crops and renders that the
plain reference makes), so that activations keep their scale through the
net as they do in a trained one; every BatchNorm's scale `bn_gamma` (a
BatchNorm network at a random init is chaotic: at scale 1, bf16 rounding
alone moves B3's head outputs by half their spread over inputs; at 0.05 by
a twentieth, smooth as a trained net); the head scaled so its outputs move
about `head_out_std` around the identity update on that batch.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from benchmark.reference import efficientnet as ref_net

IDENTITY_9D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def stream(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of one run."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF] + [
        zlib.crc32(t.encode()) if isinstance(t, str) else int(t) & 0xFFFFFFFF for t in tags]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> 1)


def superellipsoid(rng: np.random.RandomState, n_theta: int, n_phi: int):
    radii = rng.uniform(0.025, 0.06, size=3) * 1000.0
    e1, e2 = rng.uniform(0.4, 1.6), rng.uniform(0.4, 1.6)
    twist = rng.uniform(-0.8, 0.8)

    def spow(x, e):
        return np.sign(x) * np.abs(x) ** e

    T, P = np.meshgrid(np.linspace(-np.pi / 2, np.pi / 2, n_theta),
                       np.linspace(0, 2 * np.pi, n_phi, endpoint=False), indexing="ij")
    x = spow(np.cos(T), e1) * spow(np.cos(P), e2)
    y = spow(np.cos(T), e1) * spow(np.sin(P), e2)
    z = spow(np.sin(T), e1)
    ang = twist * z
    verts = np.stack([(x * np.cos(ang) - y * np.sin(ang)) * radii[0],
                      (x * np.sin(ang) + y * np.cos(ang)) * radii[1], z * radii[2]],
                     axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_theta - 1), np.arange(n_phi), indexing="ij")
    a, b = i * n_phi + j, i * n_phi + (j + 1) % n_phi
    c, d = a + n_phi, b + n_phi
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], axis=2).reshape(-1, 3)
    return verts.astype(np.float64), faces.astype(np.int64)


def two_tone(verts: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    n = rng.normal(size=3)
    n /= np.linalg.norm(n)
    c0, c1 = rng.uniform(0.15, 0.95, size=3), rng.uniform(0.15, 0.95, size=3)
    colors = np.where(((verts @ n) > 0)[:, None], c0[None], c1[None])
    return np.clip(colors + rng.normal(0, 0.03, colors.shape), 0, 1).astype(np.float32)


def meshes(cfg: dict) -> list[dict]:
    """The configuration's objects: [{label, verts (mm), faces, colors}]."""
    n_theta, n_phi = cfg["mesh_grid"]
    out = []
    for i in range(cfg["n_objects"]):
        rng = np.random.RandomState(cfg["mesh_seed"] * 1000 + i)
        verts, faces = superellipsoid(rng, n_theta, n_phi)
        out.append(dict(label=f"obj_{i + 1:06d}", verts=verts, faces=faces,
                        colors=two_tone(verts, rng)))
    return out


@torch.no_grad()
def make_weights(cfg: dict, seed: int, tag: str, x: torch.Tensor) -> dict:
    """{name: tensor} of the pose network on x's device, from the run's seed;
    x (N,6,h,w) are the calibration batch's network inputs."""
    device = x.device
    variant = cfg["backbone"]
    shapes = ref_net.param_shapes(variant)
    convs = [k for k, s in shapes.items() if k.endswith(".weight") and len(s) == 4]
    sizes = [int(np.prod(shapes[k])) for k in convs]
    gen = torch.Generator(device=device).manual_seed(stream(seed, "weights", tag))
    draw = torch.randn(sum(sizes) + int(np.prod(shapes["pose_fc.weight"])), generator=gen,
                       device=device)
    p = {}
    for k, part in zip(convs, torch.split(draw[:sum(sizes)], sizes)):
        fan_in = int(np.prod(shapes[k][1:]))
        p[k] = part.view(shapes[k]) / fan_in ** 0.5
    for k, s in shapes.items():
        if k in p or k == "pose_fc.weight":
            continue
        fill = 1.0 if k.endswith("running_var") else float(cfg["bn_gamma"]) if k.endswith(
            ("bn0.weight", "bn1.weight", "bn2.weight")) else 0.0
        p[k] = torch.full(s, fill, device=device)
    p["pose_fc.bias"] = torch.tensor(IDENTITY_9D, device=device)

    # one train-mode pass over the calibration batch sets the running statistics
    def keep(name, mean, var):
        p[f"backbone.{name}.running_mean"] = mean
        p[f"backbone.{name}.running_var"] = var

    net = ref_net.Net(p, variant, train=True, on_batch_stats=keep)
    rms = net.features(x).float().mean((2, 3)).pow(2).mean().sqrt()
    n_in = shapes["pose_fc.weight"][1]
    p["pose_fc.weight"] = draw[sum(sizes):].view(shapes["pose_fc.weight"]) * (
        cfg["head_out_std"] / (rms * n_in ** 0.5))
    return p
