"""Turntable renders.

Counterpart of the JAX package's ``utils/video.py`` (``render_turntable``,
``run_ffmpeg``): primal renders of a scene from the turntable rig, written
as PNG frames, then assembled into an mp4 by ffmpeg where ffmpeg is
installed.  Frames are written whether or not it is.  The convergence video
is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
from os.path import join

from ..models.camera import turntable_cameras
from ..models.integrator import RenderConfig, render_chunked
from .io import write_png

__all__ = ["render_turntable", "run_ffmpeg"]


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
