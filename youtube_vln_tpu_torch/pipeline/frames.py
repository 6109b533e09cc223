"""Steps 1-2: video download and frame extraction (a copy of
``youtube_vln_tpu/pipeline/frames.py``; host code, no torch).

Reference: ``scripts/video_process/download_youtube.py`` (yt_dlp, gated
behind ``allow_download``) and ``scripts/video_process/
extract_rawframes.py:6-25`` (ffmpeg @1fps to ``raw_frames/{vid}/%04d.jpg``).
``yt_dlp`` and ``ffmpeg`` are looked up only inside the calls that run
them.
"""
from __future__ import annotations

import json
import logging
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List, Optional

logger = logging.getLogger(__name__)


def load_video_ids(path) -> List[str]:
    """Video id list (one per line or JSON array)."""
    p = Path(path)
    text = p.read_text()
    if p.suffix == ".json":
        return list(json.loads(text))
    return [line.strip() for line in text.splitlines() if line.strip()]


URL_PREFIX = "https://www.youtube.com/watch?v="


def build_ydl_opts(videos_dir, proxy_ip: Optional[str] = None,
                   proxy_port: int = 1080) -> dict:
    """yt_dlp options exactly as the reference builds them
    (download_youtube.py:56-61): mp4 video+m4a audio, ``{id}.{ext}``
    naming, optional socks5 proxy (YouTube needs one in some regions)."""
    opts = {
        "format": "bestvideo[ext=mp4]+bestaudio[ext=m4a]/mp4",
        "outtmpl": str(Path(videos_dir) / "%(id)s.%(ext)s"),
    }
    if proxy_ip:
        opts["proxy"] = f"socks5://{proxy_ip}:{proxy_port}"
    return opts


def remaining_video_ids(video_ids: Iterable[str], videos_dir) -> List[str]:
    """ids minus already-downloaded files (stem match, any extension —
    reference download_youtube.py:48-55)."""
    completed = {p.stem for p in Path(videos_dir).glob("*.*")}
    return sorted(set(video_ids) - completed)


class RetryableDownloadError(Exception):
    """Raise from a downloader to trigger the exponential backoff (the
    reference's HTTP-429 branch, download_youtube.py:80-87)."""


def download_videos(video_ids: Iterable[str], out_dir, *,
                    allow_download: bool = False,
                    proxy_ip: Optional[str] = None, proxy_port: int = 1080,
                    downloader=None, sleep_time: float = 10.0,
                    max_retries: int = 6,
                    sleep_fn=None) -> List[str]:
    """Step 1 recipe (reference download_youtube.py:34-91): skip completed
    videos, download the rest with yt_dlp, exponential backoff on
    rate-limit errors, collect per-video failures.

    Gated: without ``allow_download`` it only validates presence.
    ``downloader(url)`` is injectable for testing; the default
    wraps yt_dlp.  Returns the present-video list; failures are logged.
    """
    import time

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    video_ids = list(video_ids)
    remaining = remaining_video_ids(video_ids, out_dir)
    present = sorted(set(video_ids) - set(remaining))
    if not remaining:
        return present
    if not allow_download and downloader is None:
        logger.warning("%d videos missing locally (downloads disabled)",
                       len(remaining))
        return present

    if downloader is None:
        try:
            import yt_dlp
        except ImportError as e:
            raise RuntimeError("yt_dlp is not installed") from e
        ydl_opts = build_ydl_opts(out_dir, proxy_ip, proxy_port)

        def downloader(url):
            with yt_dlp.YoutubeDL(ydl_opts) as ydl:
                ydl.extract_info(url, download=False)
                ydl.download([url])

    sleep_fn = sleep_fn or time.sleep
    failures = []
    for vid in remaining:
        backoff = sleep_time
        for _ in range(max_retries):
            try:
                downloader(URL_PREFIX + vid)
                present.append(vid)
                break
            except RetryableDownloadError:
                logger.info("backoff %ss on %s", backoff, vid)
                sleep_fn(backoff)
                backoff *= 2
            except Exception as e:
                logger.warning("failed on %s: %s", vid, e)
                failures.append(vid)
                break
        else:
            failures.append(vid)
    if failures:
        logger.warning("%d downloads failed: %s", len(failures),
                       failures[:5])
    return sorted(present)


def extract_frames(video_path, out_dir, fps: int = 1,
                   ffmpeg: Optional[str] = None) -> int:
    """Extract frames at ``fps`` into ``out_dir/%04d.jpg``
    (reference extract_rawframes.py:6-25).  Returns the frame count."""
    ffmpeg = ffmpeg or shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg not found on PATH")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [ffmpeg, "-y", "-i", str(video_path), "-vf", f"fps={fps}",
           "-q:v", "2", str(out_dir / "%04d.jpg"),
           "-loglevel", "error"]
    subprocess.run(cmd, check=True)
    return len(list(out_dir.glob("*.jpg")))


def extract_all(videos_dir, frames_dir, fps: int = 1) -> int:
    """Extract every video under videos_dir into frames_dir/{vid}/."""
    total = 0
    for video in sorted(Path(videos_dir).iterdir()):
        if video.suffix.lower() not in (".mp4", ".mkv", ".webm"):
            continue
        total += extract_frames(video, Path(frames_dir) / video.stem,
                                fps=fps)
    return total
