"""Checkpoint fetch: manifest-based parallel download with retries
(counterpart of surya_tpu/common/s3.py).

An ``s3://<path>`` checkpoint name resolves to ``{S3_BASE_URL}/<path>``,
whose ``manifest.json`` lists the files to fetch into the local model cache
``MODEL_CACHE_DIR/<path>``; a ``.download_complete`` marker ends a finished
fetch. Offline, pre-populate ``MODEL_CACHE_DIR/<path>`` or point the
per-model ``*_MODEL_CHECKPOINT`` setting at a local directory.
"""

from __future__ import annotations

import json
import os
import socket
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional
from urllib.parse import urlparse

from surya_tpu_torch.logging import get_logger
from surya_tpu_torch.settings import settings

logger = get_logger()

# hosts whose name resolution failed for good (NXDOMAIN) recently: a second
# predictor built moments later does not pay the retry ladder again; the
# entry expires, so a repaired resolver is picked up
_DNS_DEAD: dict = {}
_DNS_DEAD_TTL_S = 60.0


def _host_of(url: str) -> str:
    return urlparse(url).netloc


def _dns_recently_dead(url: str) -> bool:
    t = _DNS_DEAD.get(_host_of(url))
    return t is not None and (time.time() - t) < _DNS_DEAD_TTL_S


def _exception_chain(err: BaseException):
    """err and every exception behind it: ``__cause__``, ``__context__`` and
    urllib3's ``.reason`` (requests wraps a resolver error as
    ConnectionError <- MaxRetryError <- NameResolutionError <- gaierror, and
    which link carries it differs between versions)."""
    seen, todo = set(), [err]
    while todo:
        e = todo.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        yield e
        for nxt in (e.__cause__, e.__context__, getattr(e, "reason", None)):
            if isinstance(nxt, BaseException):
                todo.append(nxt)


def _note_dns_failure(url: str, err: Exception) -> bool:
    """Record a permanent name-resolution failure (NXDOMAIN): a
    ``socket.gaierror`` with ``EAI_NONAME`` anywhere in the chain, whatever
    its wording, or the glibc or macOS wording of it. Transient resolver
    failures (``EAI_AGAIN``, "Temporary failure in name resolution") stay on
    the retry ladder: they often heal within the backoff."""
    chain = list(_exception_chain(err))
    dead = any(isinstance(e, socket.gaierror) and e.errno == socket.EAI_NONAME for e in chain) or any(
        "Name or service not known" in str(e) or "nodename nor servname" in str(e) for e in chain
    )
    if dead:
        _DNS_DEAD[_host_of(url)] = time.time()
    return dead


def _download_file(url: str, dest: Path, retries: int = 3, backoff: float = 2.0):
    import requests

    if _dns_recently_dead(url):
        raise ConnectionError(f"host {_host_of(url)} failed DNS resolution <{_DNS_DEAD_TTL_S:.0f}s ago")
    for attempt in range(retries):
        try:
            with requests.get(url, stream=True, timeout=60) as r:
                r.raise_for_status()
                tmp = dest.with_suffix(dest.suffix + ".tmp")
                with open(tmp, "wb") as f:
                    for chunk in r.iter_content(chunk_size=1 << 20):
                        f.write(chunk)
                tmp.rename(dest)
                return
        except Exception as e:
            if _note_dns_failure(url, e) or attempt == retries - 1:
                raise  # a dead name does not heal between attempts
            logger.warning("download %s failed (%s), retrying", url, e)
            time.sleep(backoff**attempt)


def download_directory(s3_path: str, cache_dir: Optional[str] = None) -> str:
    """Fetch every file a checkpoint's manifest lists; returns the local dir."""
    rel = s3_path.removeprefix("s3://")
    local = Path(cache_dir or settings.MODEL_CACHE_DIR) / rel
    done_marker = local / ".download_complete"
    if done_marker.exists():
        return str(local)
    local.mkdir(parents=True, exist_ok=True)

    base_url = f"{settings.S3_BASE_URL}/{rel}"
    _download_file(f"{base_url}/manifest.json", local / "manifest.json")
    with open(local / "manifest.json") as f:
        manifest = json.load(f)

    files = manifest["files"] if isinstance(manifest, dict) else manifest
    with ThreadPoolExecutor(max_workers=settings.PARALLEL_DOWNLOAD_WORKERS) as ex:
        futures = [
            ex.submit(_download_file, f"{base_url}/{fname}", local / fname)
            for fname in files
            if not (local / fname).exists()
        ]
        for fut in futures:
            fut.result()
    done_marker.touch()
    return str(local)


def resolve_checkpoint(name: str) -> Optional[str]:
    """A checkpoint setting as a local directory: a local path that is a
    directory, or an ``s3://`` name already in the cache or downloadable.
    None when nothing is reachable (the caller decides whether random
    weights may stand in)."""
    if not name.startswith("s3://"):
        return name if os.path.isdir(name) else None

    rel = name.removeprefix("s3://")
    local = Path(settings.MODEL_CACHE_DIR) / rel
    if local.is_dir() and any(local.glob("*.safetensors")):
        return str(local)
    try:
        return download_directory(name)
    except Exception as e:
        logger.warning("checkpoint %s unreachable: %s", name, e)
        return None
