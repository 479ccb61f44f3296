"""General runtime utilities.

Counterpart of the JAX package's `runtime/util.py` (reference dnnlib/util.py):
`EasyDict`, the stdout/file tee `Logger`, `format_time`, `open_url`,
config-by-classname reflection (`get_obj_by_name`,
`construct_class_by_name`) and the per-phase wall-clock accumulator
`TimingUtil`.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import os
import sys
import time
import urllib.parse
import urllib.request
from typing import Any, Optional


class EasyDict(dict):
    """dict with attribute access (config-tree node)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]


class Logger:
    """Tee stdout to a log file (``file_name``), flushing after each write."""

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "w",
                 should_flush: bool = True):
        self.file = open(file_name, file_mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        sys.stdout = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        if sys.stdout is self:
            sys.stdout = self.stdout
        if self.file is not None:
            self.file.close()
            self.file = None


def format_time(seconds: float) -> str:
    """Seconds → ``'42s'``, ``'3m 05s'``, ``'2h 03m 05s'`` or ``'1d 02h 03m'``."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 60 * 60:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 24 * 60 * 60:
        return f"{s // (60 * 60)}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return f"{s // (24 * 60 * 60)}d {(s // (60 * 60)) % 24:02d}h {(s // 60) % 60:02d}m"


def open_url(url: str, cache_dir: Optional[str] = None, num_attempts: int = 10,
             verbose: bool = True):
    """An open binary file for ``url``: a local path or a ``file://`` URL is
    opened where it lies; any other URL is fetched (with retries) once and
    cached under ``cache_dir`` (``$SG3TPU_CACHE/downloads``, by default
    ``~/.cache/sg3tpu/downloads``) by the MD5 of the URL."""
    if num_attempts < 1:
        raise ValueError("num_attempts must be at least 1")
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme == "file":
        return open(urllib.request.url2pathname(parsed.path), "rb")
    if parsed.scheme == "" or os.path.exists(url):
        return open(url, "rb")
    cache_dir = cache_dir or os.path.join(
        os.environ.get("SG3TPU_CACHE", os.path.expanduser("~/.cache/sg3tpu")), "downloads")
    os.makedirs(cache_dir, exist_ok=True)
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()
    cached = [f for f in os.listdir(cache_dir) if f.startswith(url_md5)]
    if cached:
        return open(os.path.join(cache_dir, cached[0]), "rb")
    data = None
    for attempt in range(num_attempts):
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                data = resp.read()
            break
        except Exception as e:
            if attempt == num_attempts - 1:
                raise
            if verbose:
                print(f"download failed ({e}); retrying...")
            time.sleep(min(2 ** attempt, 30))
    path = os.path.join(cache_dir, f"{url_md5}_{url.split('/')[-1] or 'download'}")
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)
    return open(path, "rb")


def get_obj_by_name(name: str) -> Any:
    """``'pkg.module.Class'`` → the object."""
    module_name, _, obj_name = name.rpartition(".")
    return getattr(importlib.import_module(module_name), obj_name)


def construct_class_by_name(*args, class_name: Optional[str] = None, **kwargs):
    """Instantiate a class given its fully qualified name and arguments."""
    if class_name is None:
        raise ValueError("class_name is required")
    return get_obj_by_name(class_name)(*args, **kwargs)


class TimingUtil:
    """Per-phase wall-clock accumulator (reference setgan/utils.py)."""

    def __init__(self):
        self._totals: dict = {}
        self._counts: dict = {}
        self._starts: dict = {}

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._starts.pop(name)
        self._totals[name] = self._totals.get(name, 0.0) + dt
        self._counts[name] = self._counts.get(name, 0) + 1
        return dt

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def mean(self, name: str) -> float:
        return self._totals.get(name, 0.0) / max(self._counts.get(name, 0), 1)

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self._counts[k],
                    "mean_s": round(self.mean(k), 4)} for k, v in self._totals.items()}
