"""The coordinator's KV surface over a ``torch.distributed`` store.

The eager engine's coordinator (coordinator.py) makes four KV calls, the
ones the JAX package makes on its coordination service:

- ``key_value_set_bytes(key, value, allow_overwrite=...)``
- ``blocking_key_value_get_bytes(key, timeout_ms)``, raising a
  ``DEADLINE_EXCEEDED``-worded error on expiry (the coordinator tells an
  idle poll from a transport failure by that word);
- ``key_value_try_get_bytes(key)``, None when the key is unset;
- ``key_value_delete(key)``.

:class:`StoreKV` maps them onto the session's store: ``set``, ``check``
then ``get``, and ``delete_key``. The blocking get polls ``check`` with
a backoff from 50 us to 2 ms instead of ``Store.wait``: a TCPStore wait
that expires logs a warning from C++, and an idle coordinator expires
one every cycle. At one rank the store is ``init()``'s ``HashStore``.
"""

import time


class StoreKV:
    """The coordinator's four KV calls on ``store``."""

    def __init__(self, store):
        self.store = store

    def key_value_set_bytes(self, key, value, allow_overwrite=False):
        if not allow_overwrite and self.store.check([key]):
            raise RuntimeError(f"ALREADY_EXISTS: key {key} already set "
                               f"(allow_overwrite=False)")
        self.store.set(key, bytes(value))

    def key_value_try_get_bytes(self, key):
        if not self.store.check([key]):
            return None
        return self.store.get(key)

    def blocking_key_value_get_bytes(self, key, timeout_ms):
        deadline = time.perf_counter() + timeout_ms / 1000.0
        pause = 5e-5
        while True:
            if self.store.check([key]):
                return self.store.get(key)
            now = time.perf_counter()
            if now >= deadline:
                raise RuntimeError(f"DEADLINE_EXCEEDED: key {key} not set "
                                   f"within {timeout_ms} ms")
            time.sleep(min(pause, deadline - now))
            pause = min(pause * 2, 2e-3)

    def key_value_delete(self, key):
        self.store.delete_key(key)
