"""Runtime helpers: compilation cache, timers, run logging.

The reference's observability is CDiagnostics leveled logging + CStopWatch +
an SQLite experiment-summary DB (libkit4b/Diagnostics.cpp, SURVEY.md §5.5);
here: stdlib logging, phase timers, JSONL run records, and the XLA persistent
compile cache (a cold compile of the alignment graphs takes tens of seconds;
cached thereafter).
"""
from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager

log = logging.getLogger("kit4b_tpu")


CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str:
    """Where the persistent compile cache lives: JAX_COMPILATION_CACHE_DIR
    when set, otherwise the fixed `.jax_cache` inside the checkout (a fixed
    path, so that later processes hit the same entries)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory. JAX
    reads JAX_COMPILATION_CACHE_DIR itself; only without it is the
    directory set here."""
    import jax
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return path


def setup_logging(level: str = "info", logfile: str | None = None) -> None:
    """Dual screen+file leveled logging (CDiagnostics parity,
    libkit4b/Diagnostics.h:9-46)."""
    lvl = getattr(logging, level.upper(), logging.INFO)
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if logfile:
        handlers.append(logging.FileHandler(logfile))
    logging.basicConfig(
        level=lvl,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        handlers=handlers, force=True)


class PhaseTimer:
    """Named phase wall-clock accounting, reported in run summaries
    (CStopWatch parity, libkit4b/StopWatch.h)."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self._t0 = time.time()

    @contextmanager
    def phase(self, name: str):
        t = time.time()
        log.info("phase %s: start", name)
        try:
            yield
        finally:
            dt = time.time() - t
            self.phases[name] = self.phases.get(name, 0.0) + dt
            log.info("phase %s: %.2fs", name, dt)

    def total(self) -> float:
        return time.time() - self._t0


def append_run_record(path: str, record: dict) -> None:
    """JSONL experiment-summary record (SQLite summaries DB parity,
    ngskit4b/SQLiteSummaries.cpp:271-355)."""
    record = dict(record)
    record.setdefault("ts", time.time())
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
