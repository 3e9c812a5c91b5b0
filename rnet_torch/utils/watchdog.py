"""Stall watchdog and auto-restart supervision for training.

Port of ``rnet/utils/watchdog.py``. A blocking device call that never
returns cannot be interrupted from Python, so recovery is process-level:

- ``Watchdog``: a daemon thread watches a heartbeat that the train loop
  touches at every host-visible progress point (log, eval end, checkpoint
  save). If no beat arrives within ``timeout`` seconds the process
  hard-exits with ``EXIT_STALL`` (``os._exit``: the main thread is presumed
  stuck in native code and cannot unwind).
- ``supervise``: reruns the training command with ``--resume latest``
  whenever it exits with ``EXIT_STALL``, up to ``max_restarts`` times; any
  other exit code is returned unchanged. ``python -m rnet_torch.train``
  relaunches ``[sys.executable, "-m", "rnet_torch.train", ...]``.

Checkpoint safety: ``CheckpointManager`` writes each epoch to a temporary
name and renames it when complete, and ``latest_epoch`` matches final names
only, so a hard exit mid-save resumes from the previous complete epoch.
Pick ``timeout`` above the longest legitimate gap between beats (kernel
builds, the first step, the upload of a large device cache).
"""

from __future__ import annotations

import os
import sys
import threading
import time

# Distinct from Python's 1/2, argparse's 2, SIGKILL's 137 etc. so the
# supervisor never "recovers" an ordinary crash into a restart loop.
EXIT_STALL = 87


class Watchdog:
    """Heartbeat monitor; hard-exits (or calls ``on_stall``) on silence.

    Not started on construction — use ``start()``/``stop()`` or as a context
    manager. ``beat()`` is safe from any thread and costs one clock read.
    """

    def __init__(self, timeout: float, on_stall=None, poll: float | None = None):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be positive")
        self.timeout = float(timeout)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._on_stall = on_stall or self._exit_stall
        self._poll = poll if poll is not None else min(max(timeout / 4.0, 0.05), 10.0)
        self._thread: threading.Thread | None = None
        self.fired = False

    def beat(self) -> None:
        self._last = time.monotonic()

    def _exit_stall(self, idle: float) -> None:
        # os._exit discards buffered stdout (block-buffered when redirected
        # to a file) — flush so the log keeps every line up to the stall
        try:
            sys.stdout.flush()
        except (OSError, ValueError):  # a closed or broken stdout must not stop the exit
            pass
        sys.stderr.write(
            f"WATCHDOG: no training progress for {idle:.0f}s "
            f"(timeout {self.timeout:.0f}s) — presumed hung; "
            f"exiting {EXIT_STALL} for supervised --resume latest restart\n"
        )
        sys.stderr.flush()
        os._exit(EXIT_STALL)

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            idle = time.monotonic() - self._last
            if idle > self.timeout:
                self.fired = True
                self._on_stall(idle)
                return

    def start(self) -> "Watchdog":
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name="rnet-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll + 1.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def with_resume_latest(argv: list[str]) -> list[str]:
    """The restart command: the original argv with ``--resume latest``
    (replacing any explicit --resume value — after a stall, only the newest
    complete checkpoint continues the run)."""
    argv = list(argv)
    if "--resume" in argv:
        i = argv.index("--resume")
        if i + 1 < len(argv):
            argv[i + 1] = "latest"
        else:  # trailing bare --resume: give it a value
            argv.append("latest")
    else:
        argv += ["--resume", "latest"]
    return argv


def strip_flag(argv: list[str], flag: str, has_value: bool = True) -> list[str]:
    """Remove ``flag`` (and its value) so the child doesn't re-supervise."""
    out = []
    skip = 0
    for a in argv:
        if skip:
            skip -= 1
            continue
        if a == flag:
            skip = 1 if has_value else 0
            continue
        if has_value and a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def supervise(argv: list[str], max_restarts: int, run=None, log=None) -> int:
    """Run ``argv``; relaunch with --resume latest while it exits EXIT_STALL.

    ``run`` defaults to subprocess.call (child inherits stdout/stderr so the
    training log stream is uninterrupted across restarts). Returns the final
    exit code — EXIT_STALL itself if the restart budget is exhausted."""
    if run is None:
        import subprocess

        def run(cmd):  # unbuffered child: no log lines lost to a hard exit
            return subprocess.call(
                cmd, env={**os.environ, "PYTHONUNBUFFERED": "1"}
            )
    if log is None:
        log = lambda m: print(m, flush=True)  # noqa: E731
    rc = run(argv)
    n = 0
    while rc == EXIT_STALL and n < max_restarts:
        n += 1
        argv = with_resume_latest(argv)
        log(
            f"supervisor: stall detected — restart {n}/{max_restarts}: "
            + " ".join(argv)
        )
        rc = run(argv)
    return rc
