"""Turntable renders and convergence videos.

Counterpart of the JAX package's ``utils/video.py`` (``render_turntable``,
``run_ffmpeg``, ``convergence_video``): primal renders of a scene from the
turntable rig, or grids of optimization images over their references,
written as PNG frames, then assembled into an mp4 by ffmpeg where ffmpeg is
installed.  Frames are written whether or not it is.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
from os.path import join

import numpy as np

from ..models.camera import turntable_cameras
from ..models.integrator import RenderConfig, render_chunked
from .io import tonemap, write_png

__all__ = ["render_turntable", "run_ffmpeg", "convergence_video"]


def run_ffmpeg(frame_pattern: str, video_path: str) -> bool:
    """Frames → h264 mp4; returns False (and writes nothing) without ffmpeg."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        print("Cannot find ffmpeg, skipping video generation")
        return False
    subprocess.run(
        [ffmpeg, "-y", "-hide_banner", "-loglevel", "error", "-i", frame_pattern, "-c:v", "libx264",
         "-movflags", "+faststart", "-vf", "format=yuv420p", "-crf", "15", "-nostdin", video_path],
        check=False, stdin=subprocess.DEVNULL,
    )
    return True


def render_turntable(scene, output_dir, resx=128, resy=128, spp=64, n_frames=64, cfg=None, n_chunks=1):
    """Render ``n_frames`` turntable frames of ``scene`` (primal, seed = frame
    index) into ``output_dir/turntable/frame-NNNN.png``, then the video
    ``output_dir/video/turntable.mp4``.  Runs on the scene's device."""
    frame_dir = join(output_dir, "turntable")
    os.makedirs(frame_dir, exist_ok=True)
    cfg = dataclasses.replace(cfg or RenderConfig(), spp=spp)
    cams = turntable_cameras(n_frames, resx=resx, resy=resy, device=scene.device)
    for frame in range(n_frames):
        img = render_chunked(
            scene, seed=frame, cfg=cfg, mode="primal", camera=cams.view(frame), n_chunks=n_chunks,
            device=scene.device,
        )
        write_png(join(frame_dir, f"frame-{frame:04d}.png"), img[..., :3].cpu().numpy())
    video_dir = join(output_dir, "video")
    os.makedirs(video_dir, exist_ok=True)
    run_ffmpeg(join(frame_dir, "frame-%04d.png"), join(video_dir, "turntable.mp4"))


def _to_np(img):
    return img.detach().cpu().numpy() if hasattr(img, "detach") else np.asarray(img)


def convergence_video(output_dir, opt_images, ref_images, n_cols=3):
    """Tile each iteration's per-view images over their references into a
    grid (rows of ``n_cols`` views, each over its reference row), written as
    ``output_dir/convergence/conv-NNNN.png``, then the video
    ``output_dir/video/convergence.mp4``.  ``opt_images``: ``{iteration:
    [(H, W, 3) image per view]}``; ``ref_images``: one (H, W, 3) image per
    view (tensors or arrays).  Returns whether ffmpeg ran."""
    frame_dir = join(output_dir, "convergence")
    os.makedirs(frame_dir, exist_ok=True)
    refs = [tonemap(_to_np(r)) for r in ref_images]
    for fi, it in enumerate(sorted(opt_images)):
        imgs = [tonemap(_to_np(im)) for im in opt_images[it]]
        rows = []
        for start in range(0, len(imgs), n_cols):
            for part in (imgs[start:start + n_cols], refs[start:start + n_cols]):
                part = part + [np.zeros_like(part[0])] * (n_cols - len(part))
                rows.append(np.concatenate(part, axis=1))
        write_png(join(frame_dir, f"conv-{fi:04d}.png"), np.concatenate(rows, axis=0))
    os.makedirs(join(output_dir, "video"), exist_ok=True)
    return run_ffmpeg(join(frame_dir, "conv-%04d.png"), join(output_dir, "video", "convergence.mp4"))
