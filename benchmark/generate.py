"""The traffic generators: every input of a run, made from the seed.

- `video`: uint8 frames (T, B, H, W, 3) of each stream: a diagonal
  pattern that shifts 12 pixels a frame under per-frame noise, so that
  consecutive frames are related but not duplicates (after chip_smoke.py's
  `make_frames`), each stream with its own noise and starting shift.
- `scene`: N distinct views of one scene for pairwise inference: the same
  pattern at N shifts, normalised to [-1, 1] as DUSt3R's loader gives them.
- `room_video`: uint8 frames (T, B, H, W, 3) of each stream: a camera
  flying a smooth arc through a ray-cast box room with checkerboard walls
  (rendered on the device), under faint per-frame sensor noise:
  consecutive frames cover mostly the same surfaces, as a video does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def video(rng: np.random.Generator, t: int, b: int,
          hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    base = (np.indices((h, w)).sum(0) % 255).astype(np.float32)
    out = np.empty((t, b, h, w, 3), np.uint8)
    for s in range(b):
        shift0 = int(rng.integers(0, w))
        for i in range(t):
            pat = np.roll(base, shift0 + i * 12, axis=1)[..., None]
            noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            out[i, s] = (0.5 * pat + 0.5 * noise).astype(np.uint8)
    return out


def normalise(frames_u8: np.ndarray) -> np.ndarray:
    return frames_u8.astype(np.float32) * (2.0 / 255.0) - 1.0


def scene(rng: np.random.Generator, n: int, hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W, 3) normalised float32 views."""
    return normalise(video(rng, n, 1, hw)[:, 0])


def _look_at(eye, target):
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, np.array([0.0, 1.0, 0.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)        # columns: camera axes in world


def _room(rng: np.random.Generator, span_deg: Tuple[float, float]) -> dict:
    """A room of random size and texture, and a camera path in it: an arc
    of span_deg degrees round a look-at point, with a drift in height."""
    size = (rng.uniform(4.0, 8.0), rng.uniform(2.6, 3.4), rng.uniform(4.0, 9.0))
    room = dict(size=size, checker=rng.uniform(0.35, 0.8),
                tint=rng.uniform(0.3, 1.0, size=(3, 3)))
    room["target"] = np.array([size[0] / 2 + rng.uniform(-0.8, 0.8),
                               rng.uniform(0.8, size[1] - 0.8),
                               -size[2] / 2 + rng.uniform(-0.8, 0.8)])
    room["radius"] = rng.uniform(1.0, max(1.2, min(size[0], size[2]) / 2 - 0.8))
    room["theta0"] = rng.uniform(0.0, 2 * np.pi)
    room["span"] = np.deg2rad(rng.uniform(*span_deg)) * rng.choice([-1.0, 1.0])
    room["heights"] = rng.uniform(0.6, size[1] - 0.6, size=2)
    return room


def _eye(room: dict, k: float) -> np.ndarray:
    """The camera's position at fraction k of its path."""
    size, target, radius = room["size"], room["target"], room["radius"]
    h0, h1 = room["heights"]
    ang = room["theta0"] + room["span"] * k
    eye = np.array([target[0] + radius * np.cos(ang), h0 + (h1 - h0) * k,
                    target[2] + radius * np.sin(ang)])
    return np.clip(eye, [0.4, 0.4, -size[2] + 0.4],
                   [size[0] - 0.4, size[1] - 0.4, -0.4])


@torch.no_grad()
def room_video(rng: np.random.Generator, t: int, b: int, hw: Tuple[int, int],
               device, noise: float = 3.0) -> np.ndarray:
    """Each stream flies an arc of 90-180 degrees through its own room over
    the t frames; rendered on `device` in float32, returned on the host."""
    h, w = hw
    f = 0.5 * w / np.tan(np.deg2rad(60.0) / 2)
    v, u = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                          torch.arange(w, device=device) + 0.5, indexing="ij")
    d_cam = torch.stack([(u - w / 2) / f, (v - h / 2) / f, torch.ones_like(u)], -1)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 62)))
    out = torch.empty((t, b, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(b):
        room = _room(rng, (90.0, 180.0))
        lo = torch.tensor([0.0, 0.0, -room["size"][2]], device=device)
        hi = torch.tensor([room["size"][0], room["size"][1], 0.0], device=device)
        tint = torch.tensor(room["tint"], dtype=torch.float32, device=device)
        for i in range(t):
            eye_np = _eye(room, i / max(t - 1, 1))
            rot = torch.tensor(_look_at(eye_np, room["target"]), dtype=torch.float32,
                               device=device)
            eye = torch.tensor(eye_np, dtype=torch.float32, device=device)
            d = d_cam @ rot.T
            t_exit = torch.where(d > 0, (hi - eye) / d,
                                 torch.where(d < 0, (lo - eye) / d,
                                             torch.full_like(d, float("inf"))))
            tt, axis = t_exit.min(-1)
            pts = eye + tt[..., None] * d
            a = torch.where(axis == 0, pts[..., 1], pts[..., 0])
            c = torch.where(axis == 2, pts[..., 1], pts[..., 2])
            cell = (torch.floor(a / room["checker"])
                    + torch.floor(c / room["checker"])).remainder(2)
            col = tint[axis] * (0.55 + 0.45 * cell[..., None]) * 255.0
            col = col + noise * torch.randn(col.shape, generator=gen, device=device)
            out[i, s] = col.round().clamp(0, 255).to(torch.uint8)
    return out.cpu().numpy()
