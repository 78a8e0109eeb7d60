"""Lock factory: every module of the port obtains its synchronization
primitives here rather than calling ``threading`` directly, so that the
instrumented probe of the reference (``repro.analysis.locks``) can slot in
later.  For now each function returns the plain ``threading`` object."""
from __future__ import annotations

import threading
from typing import Any


def make_lock(name: str) -> Any:
    """A mutex for ``name`` (e.g. ``"PipelineTrace._lock"``)."""
    return threading.Lock()


def make_rlock(name: str) -> Any:
    return threading.RLock()


def make_condition(name: str, lock: Any = None) -> Any:
    return threading.Condition(lock)
