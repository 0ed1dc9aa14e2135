"""Launcher result cache (counterpart of horovod_tpu/run/cache.py).

Reference analog: horovod/run/util/cache.py — ``horovodrun`` caches slow
host-initialization checks (SSH reachability) in ``~/.horovod`` so repeated
launches on the same cluster skip them; entries go stale after a threshold
and the whole cache is invalidated when the launch parameters change.
JSON on disk here (the reference used cloudpickle; these are plain strings
and timestamps), same invalidation semantics.
"""

import hashlib
import json
import os
import threading
import time

DEFAULT_FOLDER = os.path.join(os.path.expanduser("~"), ".horovod_tpu_torch")
DEFAULT_STALENESS_MINUTES = 60


def parameters_hash(*params):
    """Stable hash of the launch parameters; a changed host list / port
    invalidates every cached result (reference: run.py:379-385)."""
    blob = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


class Cache:
    """{key: (value, timestamp)} with a staleness threshold, persisted as
    JSON under ``cache_folder`` (reference: run/util/cache.py:23-113)."""

    def __init__(self, cache_folder=DEFAULT_FOLDER,
                 staleness_minutes=DEFAULT_STALENESS_MINUTES,
                 params_hash=""):
        self._path = os.path.join(cache_folder, "cache.json")
        self._staleness_s = staleness_minutes * 60
        self._lock = threading.Lock()
        os.makedirs(cache_folder, exist_ok=True)
        content = {}
        if os.path.isfile(self._path):
            try:
                with open(self._path) as f:
                    content = json.load(f)
            except (OSError, ValueError):
                content = {}
        if content.get("parameters_hash") != params_hash:
            content = {"parameters_hash": params_hash}
        self._content = content

    def get(self, key):
        """The cached value, or None when absent or stale."""
        with self._lock:
            item = self._content.get(str(key))
            if item is None:
                return None
            value, ts = item
            if time.time() - ts > self._staleness_s:
                return None
            return value

    def put(self, key, value):
        with self._lock:
            self._content[str(key)] = (value, time.time())
            try:
                with open(self._path, "w") as f:
                    json.dump(self._content, f)
            except OSError:
                pass  # cache is best-effort
