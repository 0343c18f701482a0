"""Fault tolerance: failure injection, retry, straggler detection, preemption.

The port's copy of ``repro/train/fault.py`` (which imports no JAX), held to
it by tests/test_torch_train.py.

On a real multi-pod deployment failures surface as (a) raised exceptions from
the runtime (XLA halts, DCN timeouts), (b) SIGTERM preemptions, and (c)
silent stragglers.  The train loop composes:
  * run_with_retry      -- transient failures: re-run the step
  * checkpoint + resume -- fatal failures: restart from latest (exact data
                           replay via the step-indexed pipeline)
  * StragglerMonitor    -- per-step wall-time outlier detection
  * PreemptionHandler   -- SIGTERM -> save + clean exit
"""
from __future__ import annotations

import collections
import signal
import time
from typing import Callable, Optional, Tuple, Type, Union

import numpy as np


class SimulatedFault(RuntimeError):
    pass


class FaultInjector:
    """Deterministic failure injection for tests (seeded)."""

    def __init__(self, fail_steps=(), transient: bool = True):
        self.fail_steps = set(fail_steps)
        self.transient = transient
        self._fired: set = set()

    def check(self, step: int):
        if step in self.fail_steps and (not self.transient or step not in self._fired):
            self._fired.add(step)
            raise SimulatedFault(f"injected fault at step {step}")


Retryable = Union[Type[BaseException], Tuple[Type[BaseException], ...],
                  Callable[[BaseException], bool]]


def run_with_retry(fn: Callable, *args, retries: int = 2,
                   on_failure: Optional[Callable] = None,
                   backoff: float = 0.0, factor: float = 2.0,
                   max_backoff: float = 60.0, jitter: float = 0.0,
                   seed: int = 0, deadline: Optional[float] = None,
                   retryable: Optional[Retryable] = None,
                   sleep: Callable[[float], None] = time.sleep,
                   clock: Callable[[], float] = time.monotonic):
    """Run fn(*args); on exception retry up to `retries` times.

    backoff > 0 sleeps ``min(backoff * factor**attempt, max_backoff)``
    between attempts, stretched by up to ``jitter`` fraction of seeded
    uniform noise (``np.random.default_rng(seed)``) so co-failing ranks
    de-synchronize.  ``deadline`` bounds total elapsed seconds: a retry
    whose sleep would cross it re-raises instead.  ``retryable`` filters
    which exceptions are worth retrying — an exception class, a tuple of
    classes, or a predicate ``e -> bool``; anything else re-raises
    immediately.  ``sleep``/``clock`` are injectable for tests.
    """
    rng = np.random.default_rng(seed)
    start = clock()
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except Exception as e:          # noqa: BLE001 - deliberate catch-all
            if retryable is not None:
                ok = (retryable(e) if callable(retryable)
                      and not isinstance(retryable, type) else
                      isinstance(e, retryable))
                if not ok:
                    raise
            if attempt == retries:
                raise
            if on_failure:
                on_failure(e, attempt)
            delay = 0.0
            if backoff > 0.0:
                delay = min(backoff * factor ** attempt, max_backoff)
                if jitter > 0.0:
                    delay *= 1.0 + jitter * float(rng.random())
            if deadline is not None and clock() + delay - start > deadline:
                raise
            if delay > 0.0:
                sleep(delay)
    raise AssertionError("unreachable")


class StragglerMonitor:
    """Flags steps slower than `threshold` x rolling median.

    History is bounded at `window` samples so a long-running train loop
    does not accumulate O(steps) memory.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: collections.deque = collections.deque(maxlen=window)
        self.straggler_steps: list = []

    def record(self, step: int, duration: float):
        self.times.append(duration)
        if len(self.times) >= 5:
            med = float(np.median(self.times))
            if duration > self.threshold * med:
                self.straggler_steps.append((step, duration, med))
                return True
        return False

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


class PreemptionHandler:
    """SIGTERM/SIGINT -> set flag; the train loop checkpoints and exits.

    `install()` remembers whatever handlers were in place; `uninstall()`
    (or leaving the context manager) restores them, so a library user —
    say a pytest run or a notebook — gets its own signal handling back.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_stop = False
        self._signals = signals
        self._previous: dict = {}

    def install(self):
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def uninstall(self):
        for s, prev in self._previous.items():
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        self._previous = {}

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _handle(self, signum, frame):
        self.should_stop = True


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self.t0
