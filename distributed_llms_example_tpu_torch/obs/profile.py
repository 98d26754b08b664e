"""On-demand ``torch.profiler`` capture of the train loop (port of the JAX
package's ``obs/profile.py``; its window, trigger and event semantics).

Two triggers, one controller:

- **config window**: ``--profile-steps`` takes the count form (``3``: 3
  steps starting 2 after the run's first step; needs ``--profile-dir``) or
  an absolute inclusive window (``100:105``; the trace dir defaults under
  the output dir);
- **trigger file**: touching ``<output_dir>/obs/profile.trigger`` (its
  contents a step count, default ``DEFAULT_TRIGGER_STEPS``) starts a
  capture at the next step; polled once a step, consumed when the capture
  starts.

A capture lands in
``<trace_dir>/proc{rank:03d}-s{start:06d}-{stop:06d}-{wallclock}/`` as one
Chrome trace (``rank{rank}.pt.trace.json``: CPU activity and, on CUDA, the
card's), announced by ``profile_trace`` and ``profile_captured`` events; the
``on_capture`` hook hands it to the device-time attribution
(``obs/devprof.py`` through ``TrainerObs``).

The stop waits for the card (``obs/budget.sync_device``, counted in
``sync_device.profile_syncs``, apart from the budget's cadence syncs) so
that the trace holds completed steps: the one extra device sync, on the
window's closing step only.  A window still open when training ends is
closed by ``finalize``, its reported window clamped to the last completed
step.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

from distributed_llms_example_tpu_torch.utils.jsonlog import log_json

DEFAULT_TRIGGER_STEPS = 3


def parse_profile_steps(spec: Any) -> tuple[int, int] | int | None:
    """``"a:b"`` -> absolute inclusive window (a, b); ``"n"``/``n`` -> the
    relative count; 0/""/None -> off."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, int):
        return spec if spec > 0 else None
    s = str(spec).strip()
    if ":" in s:
        a, _, b = s.partition(":")
        start, stop = int(a), int(b)
        if stop < start or start < 1:
            raise ValueError(f"--profile-steps window {spec!r} must be start:stop with "
                             "1 <= start <= stop")
        return (start, stop)
    n = int(s)
    return n if n > 0 else None


class TorchProfilerBackend:
    """``torch.profiler`` over the CPU and, on CUDA, the card: ``start``
    opens a capture and the module scopes of the model ``model_fn()`` gives
    (``obs/devprof.open_module_scopes``; none for None), ``stop``
    closes both and writes the Chrome trace into the capture's directory."""

    def __init__(self, device_type: str, model_fn: Callable[[], Any]):
        self.device_type = device_type
        self.model_fn = model_fn
        self._prof = None
        self._dir = ""
        self._scopes: list = []

    def start(self, trace_dir: str) -> None:
        import torch

        from distributed_llms_example_tpu_torch.obs.devprof import open_module_scopes

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device_type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._dir = trace_dir
        model = self.model_fn()
        self._scopes = open_module_scopes(model) if model is not None else []
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def stop(self) -> None:
        from distributed_llms_example_tpu_torch.core.mesh import process_index
        from distributed_llms_example_tpu_torch.obs.devprof import close_module_scopes

        prof, self._prof = self._prof, None
        prof.stop()
        close_module_scopes(self._scopes)
        self._scopes = []
        prof.export_chrome_trace(os.path.join(self._dir,
                                              f"rank{process_index()}.pt.trace.json"))


class ProfileController:
    """Owns the profiler state of one training run."""

    def __init__(self, *, profile_dir: str = "", steps_spec: Any = 0, trigger_path: str = "",
                 start_step: int = 0, output_dir: str = "", backend):
        spec = parse_profile_steps(steps_spec)
        self.trigger_path = trigger_path
        self.window: tuple[int, int] | None = None
        self.profile_dir = profile_dir
        if isinstance(spec, tuple):
            self.window = spec
        elif isinstance(spec, int) and profile_dir:
            # the count form skips the run's first step (kernel loading)
            first = start_step + 2
            self.window = (first, first + spec - 1)
        if not self.profile_dir and output_dir:
            self.profile_dir = os.path.join(output_dir, "obs", "profile")
        self.backend = backend
        self.active = False
        self._stop_step = 0
        self._start_step = 0
        self._trace_dir = ""
        # on_capture(trace_dir, (start, stop), truncated) after each landed
        # capture (TrainerObs: the device account)
        self.on_capture: Callable[[str, tuple[int, int], bool], None] | None = None

    # -- loop hooks ------------------------------------------------------

    def before_step(self, next_step: int) -> None:
        """Before ``next_step`` runs: open a capture where the window
        begins (or is resumed inside), or where the trigger file appeared."""
        if self.active:
            return
        if self.window and self.window[0] <= next_step <= self.window[1]:
            self._start(next_step, self.window[1])
            return
        if self.trigger_path and os.path.exists(self.trigger_path):
            steps = DEFAULT_TRIGGER_STEPS
            try:
                with open(self.trigger_path) as f:
                    text = f.read().strip()
                if text:
                    steps = max(1, int(text))
            except (OSError, ValueError):
                pass
            try:  # consumed, so a shared filesystem does not re-trigger
                os.remove(self.trigger_path)
            except OSError:
                pass
            self._start(next_step, next_step + steps - 1)

    def after_step(self, step: int, sync_on: Any = None) -> None:
        if self.active and step >= self._stop_step:
            self._stop(sync_on, truncated=False)

    def finalize(self, sync_on: Any = None, last_step: int | None = None) -> None:
        """Training ended inside an open window: write the short capture,
        its window clamped to ``last_step``."""
        if self.active:
            self._stop(sync_on, truncated=True, last_step=last_step)

    # -- internals -------------------------------------------------------

    def _start(self, start_step: int, stop_step: int) -> None:
        from distributed_llms_example_tpu_torch.core.mesh import process_index

        self._trace_dir = os.path.join(
            self.profile_dir or ".",
            f"proc{process_index():03d}-s{start_step:06d}-{stop_step:06d}"
            f"-{time.strftime('%Y%m%d-%H%M%S')}")
        os.makedirs(self._trace_dir, exist_ok=True)
        self.backend.start(self._trace_dir)
        self.active = True
        self._start_step = start_step
        self._stop_step = stop_step

    def _stop(self, sync_on: Any, *, truncated: bool, last_step: int | None = None) -> None:
        from distributed_llms_example_tpu_torch.obs.budget import sync_device

        if sync_on is not None:
            sync_device(sync_on, purpose="profile")
        self.backend.stop()
        self.active = False
        record = {"event": "profile_trace", "dir": self.profile_dir or self._trace_dir}
        if truncated:
            record["truncated"] = True
        elif self.window and self._stop_step == self.window[1]:
            record["steps"] = self.window[1] - self.window[0] + 1
        else:
            record["trace_dir"] = self._trace_dir
        log_json(record, all_processes=True)
        stop = self._stop_step
        if truncated and last_step is not None:
            stop = max(self._start_step, min(stop, int(last_step)))
        window = (self._start_step, stop)
        captured: dict[str, Any] = {"event": "profile_captured", "path": self._trace_dir,
                                    "window": [int(window[0]), int(window[1])],
                                    "steps": int(window[1] - window[0] + 1)}
        if truncated:
            captured["truncated"] = True
        log_json(captured, all_processes=True)
        if self.on_capture is not None:
            self.on_capture(self._trace_dir, window, truncated)
