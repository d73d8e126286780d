"""Per-scene occupancy video rendering.

A numpy copy of coocc_tpu/evaluation/video.py (the reference's
visualize/visualize_nusc_video.py): walk per-scene prediction folders,
render each sample as the BEV panels of evaluation/visualize.py (pred |
gt) and write the frames at 10 fps with cv2's VideoWriter (mp4v), or as an
animated GIF (PIL) where cv2 is missing or its writer does not open.

Input layout (evaluation/savers.py:save_output_nuscenes with a scene
name): <pred_dir>/<scene_name>/<sample_token>.npz (keys pred [, gt]),
sorted by name within a scene (the savers name files in temporal order).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .visualize import NUSC_PALETTE, bev_image


def render_frame(npz_path: str, palette: np.ndarray = NUSC_PALETTE,
                 upscale: int = 3) -> np.ndarray:
    """One npz -> [H, W, 3] uint8 frame (pred | gt side by side)."""
    data = np.load(npz_path)
    panels = [bev_image(data["pred"], palette)]
    if "gt" in data:
        panels.append(bev_image(data["gt"], palette))
    # BEV images are [X, Y, 3]; shown with +x right, +y up
    imgs = [np.transpose(p, (1, 0, 2))[::-1] for p in panels]
    frame = np.concatenate(imgs, axis=1).astype(np.uint8)
    if upscale > 1:
        frame = np.repeat(np.repeat(frame, upscale, 0), upscale, 1)
    return frame


def _write_gif(frames: List[np.ndarray], out_path: str, fps: int) -> str:
    from PIL import Image
    gif = os.path.splitext(out_path)[0] + ".gif"
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(gif, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
    return gif


def write_video(frames: List[np.ndarray], out_path: str,
                fps: int = 10) -> str:
    """Write the frames as an mp4 (cv2), or as a GIF beside out_path
    where cv2 is missing or its writer does not open; returns the path
    written."""
    assert frames, "no frames to write"
    h, w = frames[0].shape[:2]
    try:
        import cv2
    except ImportError:
        return _write_gif(frames, out_path, fps)
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    if not vw.isOpened():
        return _write_gif(frames, out_path, fps)
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))   # RGB -> BGR
    vw.release()
    return out_path


def make_scene_video(scene_dir: str, out_path: Optional[str] = None,
                     fps: int = 10, palette: np.ndarray = NUSC_PALETTE,
                     upscale: int = 3) -> str:
    """Every npz of one scene folder as a video; returns the path written
    (mp4, or gif)."""
    files = sorted(f for f in os.listdir(scene_dir) if f.endswith(".npz"))
    if not files:
        raise FileNotFoundError(f"no .npz predictions in {scene_dir}")
    frames = [render_frame(os.path.join(scene_dir, f), palette, upscale)
              for f in files]
    out_path = out_path or (scene_dir.rstrip("/") + "_demo.mp4")
    return write_video(frames, out_path, fps=fps)


def make_all_scene_videos(pred_dir: str, save_dir: str, fps: int = 10,
                          scene_name: Optional[str] = None) -> List[str]:
    """Each subfolder of pred_dir that holds npz predictions is a scene:
    write <save_dir>/<scene>_demo.mp4 for each (or only scene_name)."""
    os.makedirs(save_dir, exist_ok=True)
    scenes = sorted(
        d for d in os.listdir(pred_dir)
        if os.path.isdir(os.path.join(pred_dir, d))
        and any(f.endswith(".npz")
                for f in os.listdir(os.path.join(pred_dir, d))))
    if scene_name is not None:
        if scene_name not in scenes:
            raise FileNotFoundError(f"{scene_name} not under {pred_dir}")
        scenes = [scene_name]
    return [make_scene_video(os.path.join(pred_dir, s),
                             os.path.join(save_dir, f"{s}_demo.mp4"),
                             fps=fps)
            for s in scenes]
