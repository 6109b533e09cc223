"""Cached asset lookup (a copy of the lookup half of
``youtube_vln_tpu/utils/file_cache.py``, reference ``vilbert/file_utils.py``).

The reference resolves model names, URLs and S3 paths to local files in a
cache whose entries are named sha256(url)[.sha256(etag)] (the AllenNLP
scheme).  This copy finds what is already there: a local path passes
through, and a URL resolves to its cache entry, under the etag-less name
or under any etag-suffixed name an earlier online run stored.  It fetches
nothing: ``allow_download=True`` on a miss raises with the URL and the path
to place the file at.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional, Tuple, Union

CACHE_DIR = Path(os.environ.get(
    "VLN_TPU_CACHE", Path.home() / ".cache" / "youtube_vln_tpu"))


def url_to_filename(url: str, etag: Optional[str] = None) -> str:
    """sha256(url)[.sha256(etag)] — reference file_utils.py:42-57."""
    name = hashlib.sha256(url.encode()).hexdigest()
    if etag:
        name += "." + hashlib.sha256(etag.encode()).hexdigest()
    return name


def filename_to_url(filename: str,
                    cache_dir: Optional[Path] = None) -> Tuple[str, Optional[str]]:
    """Recover (url, etag) from a cache entry's .json sidecar
    (reference file_utils.py:60-83)."""
    cache_dir = Path(cache_dir or CACHE_DIR)
    meta_path = cache_dir / (filename + ".json")
    if not meta_path.exists():
        raise FileNotFoundError(f"metadata file {meta_path} does not exist")
    with open(meta_path) as f:
        meta = json.load(f)
    return meta["url"], meta.get("etag")


def split_s3_path(url: str) -> Tuple[str, str]:
    """s3://bucket/key -> (bucket, key) — reference file_utils.py:109-120."""
    from urllib.parse import urlparse
    parsed = urlparse(url)
    if not parsed.netloc or not parsed.path:
        raise ValueError(f"bad s3 path {url}")
    return parsed.netloc, parsed.path.lstrip("/")


def get_from_cache(url: str, cache_dir: Optional[Path] = None,
                   allow_download: bool = False) -> Path:
    """The cache entry of ``url`` (reference file_utils.py:150-233, offline):
    the etag-less name first, then the newest etag-suffixed entry, skipping
    the .json and .tmp sidecars.  A miss raises ``FileNotFoundError``; with
    ``allow_download`` it raises ``RuntimeError``, since this package
    downloads nothing."""
    cache_dir = Path(cache_dir or CACHE_DIR)
    bare = cache_dir / url_to_filename(url)
    if bare.exists():
        return bare
    matches = sorted((p for p in cache_dir.glob(url_to_filename(url) + ".*")
                      if p.suffix not in (".json", ".tmp")),
                     key=lambda p: p.stat().st_mtime, reverse=True)
    if matches:
        return matches[0]
    if allow_download:
        raise RuntimeError(f"{url} is not cached and this package downloads "
                           f"nothing: fetch it and place it at {bare}")
    raise FileNotFoundError(
        f"{url} is not cached and downloads are disabled; place the file at "
        f"{bare} manually")


def cached_path(name_or_path: Union[str, Path],
                cache_dir: Optional[Path] = None,
                allow_download: bool = False) -> Path:
    """Local path | http(s):// | s3:// -> local file
    (reference file_utils.py:86-107)."""
    p = Path(name_or_path)
    if p.exists():
        return p
    url = str(name_or_path)
    if url.startswith(("http://", "https://", "s3://")):
        return get_from_cache(url, cache_dir, allow_download)
    raise FileNotFoundError(f"file or url not found: {name_or_path}")
