"""What the whole-file ingest reports (counterpart of the parts of
cocoa_tpu/data/ingest.py that its whole-file path emits): one
:class:`IngestReport` per loaded LIBSVM file, the typed ``ingest``
event's payload, and :func:`peak_rss_bytes`.  The streamed ingest
(``--ingest``, ``--ingestCache``) is not ported yet."""

from __future__ import annotations

import dataclasses
import os


def peak_rss_bytes() -> int:
    """This process's lifetime peak resident set (ru_maxrss is kB on
    Linux); 0 where ``resource`` is absent."""
    try:
        import resource
    except ImportError:
        return 0
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@dataclasses.dataclass
class IngestReport:
    """The typed ``ingest`` telemetry payload (one per loaded file)."""

    mode: str                # "stream" | "whole"
    path: str
    file_bytes: int
    processes: int
    parse_seconds: float     # this process: parse + shard build
    bytes_read: int          # this process: parsed bytes
    rows: int                # rows this process materialized
    nnz: int
    n: int                   # global dataset facts
    total_nnz: int
    peak_rss_bytes: int
    cache: str = "off"       # the --ingestCache outcome: off here

    def as_fields(self) -> dict:
        return dataclasses.asdict(self)


def whole_report(path: str, data, seconds: float) -> IngestReport:
    """The report of one whole-file load of ``path`` (``data`` the parsed
    file, ``seconds`` its parse and shard build), as the JAX CLI's
    ``whole_report`` (cocoa_tpu/cli.py:1343-1358): one process reads the
    whole file."""
    try:
        fsize = os.path.getsize(path)
    except OSError:
        fsize = 0
    nnz = int(data.indptr[-1])
    return IngestReport(mode="whole", path=path, file_bytes=fsize,
                        processes=1, parse_seconds=seconds,
                        bytes_read=fsize, rows=data.n, nnz=nnz, n=data.n,
                        total_nnz=nnz, peak_rss_bytes=peak_rss_bytes())
