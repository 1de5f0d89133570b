"""In-loop telemetry of the port (counterpart of cocoa_tpu/telemetry/):
structured event stream, run manifest, metrics textfile, span tracing,
flight recorder, round-windowed profiler capture and the offline trace
report.

- :mod:`cocoa_torch.telemetry.events` — the host-side event bus: typed,
  ordered records (``run_start`` with the full config manifest,
  ``round_eval``, ``sigma_backoff``, ``checkpoint_write``, ``restart``,
  ``divergence``, ``run_end``, ...) appended to a JSONL sink and fanned
  out to subscribers; and ``DeviceTap``, which decodes the device loop's
  fetched eval rows into the same events.
- :mod:`cocoa_torch.telemetry.metrics` — a Prometheus-style textfile
  refreshed on the bus's events.
- :mod:`cocoa_torch.telemetry.schema` — the JSONL schema checker
  (``python -m cocoa_torch.telemetry.schema FILE...``).
- :mod:`cocoa_torch.telemetry.tracing` — span tracing (``--trace``):
  timed host-side phases emitted as typed ``span`` events.
- :mod:`cocoa_torch.telemetry.trace_report` — the offline assembler
  (``python -m cocoa_torch.telemetry.trace_report``): Perfetto/Chrome
  trace, per-round critical path, stragglers.
- :mod:`cocoa_torch.telemetry.recorder` — the crash flight recorder.
- :mod:`cocoa_torch.telemetry.profiling` — ``--profile`` with
  ``torch.profiler``, whole run or a round window.

Soundness: telemetry is side-effect-only.  Nothing here reads the card:
the events are built from what the run already fetched (each eval's
metrics, each super-block's rows), and no span synchronizes, so a
telemetry-on run is bit-identical to a telemetry-off run with the same
number of fetches (tests/test_torch_telemetry.py).
"""

from cocoa_torch.telemetry import events  # noqa: F401
from cocoa_torch.telemetry.events import get_bus  # noqa: F401
