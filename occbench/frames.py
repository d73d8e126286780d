"""The frame generator every traffic mix reads.

A frame is one B=1 sample of a CoOcc configuration: six cameras on a ring
with uniform pixels, their calibration, the occupancy targets, and one
LiDAR cloud. The cameras, calibration and targets follow the port's
synthetic batch (copied, not imported: the yardstick may not move when the
program does); the LiDAR cloud is ray-cast instead of uniform, because a
real sweep is sparse and lies on surfaces, which sets how many cells the
sparse encoders find active:

  * a spinning sensor at the origin with `beams` beams spread evenly from
    `elev_top_deg` down to `elev_bottom_deg` (nuScenes' 32-beam LiDAR:
    +10 to -30 degrees, Caesar et al., arXiv:1903.11027), `azimuths`
    rays a beam and sweep;
  * `sweeps` sweeps, the ego `ego_step_m` further along x each one: the
    past sweeps are cast from behind the present pose, in its frame, and
    carry their time lag as the fifth feature (intensity the fourth);
  * the rays hit a ground plane `sensor_height_m` below the sensor, and
    axis-aligned boxes standing on it: cars, pedestrians and buildings,
    `boxes_min`..`boxes_max` of them, their mix and sizes in the traffic
    file;
  * the first hit of each ray inside the point-cloud range is kept; of
    those, `valid_points` in sensor order (a seeded subset), padded with
    zeros to the config's `max_points` slots.

Every frame of a pool is drawn from (seed, frame index): the same seed gives
the same frames, whatever the device. The draws are made on `device` with a
torch.Generator, in a few large calls, then the frame is moved to pinned
host memory.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# the fields the eval forward reads; training reads every field
EVAL_FIELDS = ("imgs", "rots", "trans", "intrins", "post_rots",
               "post_trans", "bda", "points", "points_mask")


def camera_ring(n_cams: int):
    """Outward-looking cameras evenly spaced on a ring (cam z = forward):
    [N, 3, 3] camera-to-ego rotations and [N, 3] translations."""
    rots, trans = [], []
    for i in range(n_cams):
        yaw = 2 * np.pi * i / n_cams
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        rots.append(np.stack([right, -up, fwd], axis=1))
        trans.append(fwd * 0.5)
    return (np.stack(rots).astype(np.float32),
            np.stack(trans).astype(np.float32))


def _calibration(n_cams: int, H: int, W: int) -> Dict[str, np.ndarray]:
    rots, trans = camera_ring(n_cams)
    intr = np.zeros((3, 3), np.float32)
    intr[0, 0] = intr[1, 1] = W * 0.6
    intr[0, 2] = (W - 1) / 2
    intr[1, 2] = (H - 1) / 2
    intr[2, 2] = 1.0
    eye = np.eye(3, dtype=np.float32)
    return {"rots": rots[None], "trans": trans[None],
            "intrins": np.broadcast_to(intr, (1, n_cams, 3, 3)).copy(),
            "post_rots": np.broadcast_to(eye, (1, n_cams, 3, 3)).copy(),
            "post_trans": np.zeros((1, n_cams, 3), np.float32),
            "bda": eye[None].copy()}


def _boxes(rng: np.random.Generator, lidar: dict) -> np.ndarray:
    """[n, 6] (xmin, ymin, zmin, xmax, ymax, zmax) boxes on the ground,
    none within `clear_radius_m` of any sensor pose."""
    n = int(rng.integers(lidar["boxes_min"], lidar["boxes_max"] + 1))
    kinds = lidar["box_kinds"]
    share = np.asarray([k["share"] for k in kinds], np.float64)
    pick = rng.choice(len(kinds), size=n, p=share / share.sum())
    ground = -lidar["sensor_height_m"]
    reach = lidar["box_reach_m"]
    out = []
    for k in pick:
        lo, hi = np.asarray(kinds[k]["size_min_m"]), \
            np.asarray(kinds[k]["size_max_m"])
        size = lo + (hi - lo) * rng.random(3)
        while True:
            c = rng.uniform(-reach, reach, 2)
            if np.hypot(*c) > lidar["clear_radius_m"] + size[:2].max():
                break
        out.append([c[0] - size[0] / 2, c[1] - size[1] / 2, ground,
                    c[0] + size[0] / 2, c[1] + size[1] / 2, ground + size[2]])
    return np.asarray(out, np.float32)


def ray_directions(lidar: dict, device) -> torch.Tensor:
    """[beams * azimuths, 3] unit directions of one sweep, beam-major."""
    el = torch.linspace(math.radians(lidar["elev_top_deg"]),
                        math.radians(lidar["elev_bottom_deg"]),
                        lidar["beams"], dtype=torch.float64, device=device)
    az = torch.arange(lidar["azimuths"], dtype=torch.float64,
                      device=device) * (2 * math.pi / lidar["azimuths"])
    el, az = torch.meshgrid(el, az, indexing="ij")
    d = torch.stack([el.cos() * az.cos(), el.cos() * az.sin(), el.sin()], -1)
    return d.reshape(-1, 3).float()


def first_hits(origin: torch.Tensor, dirs: torch.Tensor,
               boxes: torch.Tensor, ground_z: float) -> torch.Tensor:
    """[R] distance along each ray to its first hit (the ground plane z =
    ground_z or a box), inf where it hits nothing."""
    t = torch.where(dirs[:, 2] < 0, (ground_z - origin[2]) / dirs[:, 2],
                    torch.full_like(dirs[:, 2], float("inf")))
    inv = 1.0 / torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9),
                            dirs)                              # [R, 3]
    for i in range(0, boxes.shape[0], 16):
        b = boxes[i:i + 16]                                    # [n, 6]
        t0 = (b[None, :, :3] - origin) * inv[:, None]          # [R, n, 3]
        t1 = (b[None, :, 3:] - origin) * inv[:, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        hit = (near <= far) & (near > 0)
        tb = torch.where(hit, near, torch.full_like(near, float("inf")))
        t = torch.minimum(t, tb.amin(-1))
    return t


def lidar_cloud(cfg, lidar: dict, seed: int, index: int, device):
    """([P, 5] points, [P] mask) of frame `index`: `valid_points` first
    hits in the pc range, in sensor order, then zero padding."""
    rng = np.random.default_rng([seed, index, 1])
    boxes = torch.from_numpy(_boxes(rng, lidar)).to(device)
    dirs = ray_directions(lidar, device)
    pcr = torch.tensor(cfg.point_cloud_range, dtype=torch.float32,
                       device=device)
    ground = -lidar["sensor_height_m"]
    pts = []
    for k in range(lidar["sweeps"]):
        # sweep k is k steps back along x; its points in the present frame
        origin = torch.tensor([-k * lidar["ego_step_m"], 0.0, 0.0],
                              device=device)
        t = first_hits(origin, dirs, boxes, ground)
        p = origin + dirs * t[:, None]
        keep = torch.isfinite(t) & (p >= pcr[:3]).all(-1) & \
            (p < pcr[3:]).all(-1)
        p = p[keep]
        feat = torch.stack([torch.zeros_like(p[:, 0]),
                            torch.full_like(p[:, 0], k * lidar["sweep_s"])],
                           -1)
        pts.append(torch.cat([p, feat], -1))
    pts = torch.cat(pts)
    n_valid = lidar["valid_points"]
    if pts.shape[0] < n_valid:
        raise ValueError(f"the scene gives {pts.shape[0]} hits in range, "
                         f"fewer than the {n_valid} the traffic asks for")
    g = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2 ** 62)))
    take = torch.randperm(pts.shape[0], generator=g,
                          device=device)[:n_valid].sort().values
    pts = pts[take]
    pts[:, 3] = torch.rand(n_valid, generator=g, device=device)
    P = cfg.pts.max_points
    out = torch.zeros((P, 5), dtype=torch.float32, device=device)
    out[:n_valid] = pts
    mask = torch.zeros(P, dtype=torch.bool, device=device)
    mask[:n_valid] = True
    return out, mask


def make_frame(cfg, traffic: dict, seed: int, index: int, device,
               fields=None) -> Dict[str, torch.Tensor]:
    """Frame `index` of the pool of `seed`, as a dict of tensors on
    `device` with a leading batch axis of 1 (the port's Batch fields)."""
    g = torch.Generator(device=device).manual_seed(
        int(np.random.default_rng([seed, index, 0]).integers(0, 2 ** 62)))
    N = cfg.data.num_cams
    H, W = cfg.data.input_size
    out = {k: torch.from_numpy(v).to(device)
           for k, v in _calibration(N, H, W).items()}
    if cfg.use_camera:
        out["imgs"] = torch.rand((1, N, H, W, 3), generator=g, device=device)
    d0, d1 = cfg.grid.dbound[0], cfg.grid.dbound[1]
    depth = d0 + (d1 - d0) * torch.rand((1, N, H, W), generator=g,
                                        device=device)
    keep = torch.rand((1, N, H, W), generator=g, device=device) > 0.98
    out["gt_depths"] = depth * keep
    if cfg.use_lidar:
        pts, mask = lidar_cloud(cfg, traffic["lidar"], seed, index, device)
        out["points"], out["points_mask"] = pts[None], mask[None]
    X, Y, Z = cfg.occ_size
    label = torch.randint(0, cfg.num_classes, (1, X, Y, Z), generator=g,
                          device=device)
    label = torch.where(torch.rand((1, X, Y, Z), generator=g,
                                   device=device) < 0.7, 0, label)
    label = torch.where(torch.rand((1, X, Y, Z), generator=g,
                                   device=device) < 0.02, 255, label)
    out["gt_occ"] = label.to(torch.int32)
    Q = 2048
    pcr = torch.tensor(cfg.point_cloud_range, dtype=torch.float32,
                       device=device)
    po = pcr[:3] + (pcr[3:] - pcr[:3]) * torch.rand((1, Q, 3), generator=g,
                                                    device=device)
    lab = torch.randint(1, cfg.num_classes, (1, Q, 1), generator=g,
                        device=device).float()
    out["points_occ"] = torch.cat([po, lab], -1)
    out["points_occ_mask"] = torch.ones((1, Q), dtype=torch.bool,
                                        device=device)
    if fields is not None:
        out = {k: v for k, v in out.items() if k in fields}
    return out


def frame_pool(cfg, traffic: dict, seed: int, device, fields=None):
    """The traffic's pool of distinct frames, made on `device` and kept in
    pinned host memory (plain host memory where there is no card)."""
    pool = []
    for i in range(traffic["pool_frames"]):
        f = make_frame(cfg, traffic, seed, i, device, fields)
        pin = torch.device(device).type == "cuda"
        pool.append({k: (v.cpu().pin_memory() if pin else v.clone())
                     for k, v in f.items()})
    return pool
