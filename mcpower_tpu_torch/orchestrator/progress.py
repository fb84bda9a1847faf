"""Structured progress events and cooperative cancellation.

The engine dispatches sims in chunks; between chunks the orchestrator emits
:class:`ProgressEvent`s to a host callback and polls the cancellation token —
the same host-control model as the reference's ProgressSink / CancellationToken
(crates/engine-orchestrator/src/progress.rs, cancel.rs) with the chunk
boundary playing the role of the per-sim poll (an O(1) atomic there; here the
natural quantum of one batched pass over a chunk of sims).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class ProgressEvent:
    kind: str  # started | sims_completed | scenario_started | n_point_completed | completed | cancelled
    scenario: Optional[str] = None
    done: int = 0
    total: int = 0
    payload: Any = None


class CancellationToken:
    """Thread-safe cancel flag polled between dispatch chunks."""

    def __init__(self) -> None:
        self._flag = threading.Event()

    def cancel(self) -> None:
        self._flag.set()

    def is_cancelled(self) -> bool:
        return self._flag.is_set()

    def __call__(self) -> bool:  # engine-side poll signature
        return self.is_cancelled()


class ProgressRouter:
    """Fans ProgressEvents into a user callback.

    The user callback may be:
    * ``None`` — silent;
    * a callable ``(done, total) -> bool | None`` — tqdm-style; returning
      False cancels the run (reference engine-py callable contract);
    * ``True`` — an internal text progress line.
    """

    def __init__(self, callback, cancel: Optional[CancellationToken] = None):
        self.cancel = cancel or CancellationToken()
        self._cb: Optional[Callable] = None
        self._print = False
        self._tqdm = None
        self._tqdm_factory = None
        if callback is True:
            # tqdm when available (the reference's Python-port progress UI),
            # plain text otherwise.
            try:
                from tqdm.auto import tqdm as _tqdm

                self._tqdm_factory = _tqdm
            except Exception:
                self._print = True
        elif callable(callback):
            self._cb = callback

    def emit(self, event: ProgressEvent) -> None:
        if event.kind == "sims_completed":
            if self._cb is not None:
                # A callback exception is treated as a cancel request, not a
                # crash (reference engine-py boundary: exception in the
                # callback → cancel → KeyboardInterrupt at the API edge).
                try:
                    keep_going = self._cb(event.done, event.total)
                except Exception:
                    self.cancel.cancel()
                    return
                if keep_going is False:
                    self.cancel.cancel()
            elif self._tqdm_factory is not None:
                if self._tqdm is None or self._tqdm.total != event.total:
                    if self._tqdm is not None:
                        self._tqdm.close()
                    self._tqdm = self._tqdm_factory(
                        total=event.total,
                        desc=f"sims[{event.scenario}]" if event.scenario else "sims",
                        unit="sim",
                    )
                self._tqdm.update(event.done - self._tqdm.n)
                if event.done >= event.total:
                    self._tqdm.close()
                    self._tqdm = None
            elif self._print:
                pct = 100.0 * event.done / max(event.total, 1)
                label = f" [{event.scenario}]" if event.scenario else ""
                print(f"\r  power sims{label}: {event.done}/{event.total} ({pct:.0f}%)",
                      end="", flush=True)
                if event.done >= event.total:
                    print()

    def chunk_callback(self, scenario: Optional[str], total: int):
        def cb(done, _total_chunk):
            self.emit(ProgressEvent("sims_completed", scenario=scenario, done=done, total=total))
        return cb
