"""Resumable training checkpoints (counterpart of cocoa_tpu/checkpoint.py).

A round-stamped save of the whole optimizer state -- w, the per-shard
alpha, the sched vector of a scheduled or accelerated run and the accel
bank ``hist`` -- restorable into a fresh process, in the JAX package's
file format: ``<algorithm>-r<round:06d>.npz`` (spaces in the algorithm
turned to ``_``) holding the arrays and a ``_meta`` JSON member (round,
seed, the last certified gap, the sched vector as a float list, the
arrays' shapes), beside a ``.json`` sidecar.  Each package reads the
other's files.

The writer keeps the newest :data:`KEEP_GENERATIONS` generations of an
algorithm; :func:`latest` validates each generation newest first and
falls back to the previous one when the newest is torn or corrupt.

Tensors are copied to the host as owned numpy arrays before they are
written: a save is one of the moments the host reads the card.  A
bfloat16 tensor is written as the 2-byte void array (``|V2``) that the
JAX package writes for its bfloat16 arrays, the same bytes; on load a
``|V2`` member comes back as a bfloat16 tensor (numpy has no bfloat16),
so a bf16 run's checkpoint resumes, the port's and the JAX package's.

Telemetry, as in the JAX package: a ``checkpoint_save`` span around each
save and a ``checkpoint_write`` event when its files landed, a
``checkpoint_validate`` span around each validation that reads the
file, and a ``checkpoint_corrupt`` event for each generation
:func:`latest` skips.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Optional

import numpy as np
import torch

from cocoa_torch.telemetry import events as _events
from cocoa_torch.telemetry import tracing as _tracing

# round-stamped generations kept per algorithm; the newest is the resume
# point, the one before it the fallback when the newest fails validation
KEEP_GENERATIONS = 2

_STAMP = r"-r(\d+)\.npz$"
_BF16 = np.dtype("V2")


def host_array(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as an owned numpy
    array on the host; a bfloat16 tensor as its ``|V2`` bytes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16).copy()
        return x.numpy().copy()
    return np.array(x, copy=True)


def _from_file(a: np.ndarray):
    """An archive member as the port reads it: a ``|V2`` member as a
    bfloat16 tensor (through an int16 view), any other as it is."""
    if a.dtype == _BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def save(directory: str, algorithm: str, round_t: int, w, alpha=None,
         seed: int = 0, sched=None, hist=None,
         gap: Optional[float] = None, tenant_gaps=None,
         tenant_cert_ts=None) -> str:
    """Write the checkpoint of ``round_t``; returns its path.

    ``w``, ``alpha`` and ``hist`` (the ``--accel`` bank, (2, K, n_shard))
    are tensors or arrays; ``sched`` the float32 sched vector, which rides
    the meta as a list of floats (exact: a float32 is a JSON double).
    ``gap`` is the last certified duality gap the run saw before the save
    (None without one).  ``tenant_gaps`` and ``tenant_cert_ts`` are a
    (T, d) catalogue's per-tenant certified gaps and certification times,
    one of each a tenant row, under the JAX package's meta keys; a
    server reads them as the catalogue's per-tenant freshness.

    Both files are written to temporary names and renamed in, the
    ``.npz`` last: :func:`latest` discovers a checkpoint by its ``.npz``,
    so a process killed mid-save leaves no discoverable half-written
    checkpoint."""
    with _tracing.span("checkpoint_save", algorithm=algorithm,
                       round=int(round_t)):
        return _save(directory, algorithm, round_t, w, alpha=alpha,
                     seed=seed, sched=sched, hist=hist, gap=gap,
                     tenant_gaps=tenant_gaps, tenant_cert_ts=tenant_cert_ts)


def _save(directory, algorithm, round_t, w, alpha=None, seed=0, sched=None,
          hist=None, gap=None, tenant_gaps=None, tenant_cert_ts=None) -> str:
    os.makedirs(directory, exist_ok=True)
    algorithm = algorithm.replace(" ", "_")
    path = os.path.join(directory, f"{algorithm}-r{round_t:06d}.npz")
    w = host_array(w)
    meta = {"algorithm": algorithm, "round": round_t, "seed": seed}
    if gap is not None:
        meta["gap"] = float(gap)
    if tenant_gaps is not None or tenant_cert_ts is not None:
        # both lists or neither, each covering every tenant row: a short
        # list would mislabel the per-tenant gap-age series
        if w.ndim != 2:
            raise ValueError(
                "tenant_gaps/tenant_cert_ts only ride a stacked (T, d) "
                f"catalogue checkpoint — w has shape {w.shape}")
        for name, vals in (("tenant_gaps", tenant_gaps),
                           ("tenant_cert_ts", tenant_cert_ts)):
            if vals is None or len(vals) != w.shape[0]:
                raise ValueError(
                    f"{name} must carry one entry per tenant row: got "
                    f"{None if vals is None else len(vals)} entries "
                    f"for a {w.shape[0]}-tenant catalogue")
        meta["tenant_gaps"] = [float(v) for v in tenant_gaps]
        meta["tenant_cert_ts"] = [float(v) for v in tenant_cert_ts]
    if sched is not None:
        meta["sched"] = [float(v) for v in
                         host_array(sched).astype(np.float32)]
    extra = {name: host_array(x) for name, x in (("alpha", alpha),
                                                  ("hist", hist))
             if x is not None}
    # the shapes let validate() catch a torn archive whose zip still opens
    meta["shapes"] = {name: list(a.shape)
                      for name, a in (("w", w), *extra.items())}
    # the meta travels inside the archive (a unicode array, no pickling);
    # the sidecar is for people and for checkpoints without it
    arrays = {"w": w, "_meta": np.array(json.dumps(meta)), **extra}
    pid = os.getpid()
    tmp = f"{path}.tmp.{pid}"
    with open(tmp, "wb") as f:  # a handle: savez must not append .npz
        np.savez(f, **arrays)
    with open(f"{path}.json.tmp.{pid}", "w") as f:
        json.dump(meta, f)
    os.replace(f"{path}.json.tmp.{pid}", path + ".json")
    os.replace(tmp, path)
    # sweep temporary files of this algorithm's earlier interrupted saves;
    # this round's are left alone (a peer process may be writing them)
    for name in os.listdir(directory):
        if (name.startswith(f"{algorithm}-") and ".tmp." in name
                and f"r{round_t:06d}" not in name):
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass
    # keep the newest KEEP_GENERATIONS at or below this round: higher
    # rounds are an earlier run's leftovers in a reused directory, and
    # pruning against them would delete the file just written
    stamp = re.compile(re.escape(algorithm) + _STAMP)
    ours = [p for p in generations(directory, algorithm)
            if int(stamp.search(p).group(1)) <= round_t]
    for old in ours[:-KEEP_GENERATIONS]:
        for victim in (old, old + ".json"):
            try:
                os.unlink(victim)
            except OSError:
                pass
    # every save goes through here: the one emission point of the
    # checkpoint_write event
    _events.get_bus().emit("checkpoint_write", algorithm=algorithm,
                           round=int(round_t), path=path)
    return path


def generations(directory: str, algorithm: str) -> list:
    """Round-stamped checkpoint paths of ``algorithm``, oldest to newest,
    in numeric round order (no validation: :func:`latest` validates).
    The exact ``<algorithm>-r<round>.npz`` stamp is matched, so ``CoCoA``
    never claims ``CoCoA+``'s files."""
    if not os.path.isdir(directory):
        return []
    algorithm = algorithm.replace(" ", "_")
    pat = re.compile(re.escape(algorithm) + _STAMP)
    stamped = [(m, f) for f in os.listdir(directory)
               if f.startswith(f"{algorithm}-r") and (m := pat.search(f))]
    # past round 999999 the 06d stamp widens: sort by the number
    stamped.sort(key=lambda mf: (int(mf[0].group(1)), mf[1]))
    return [os.path.join(directory, f) for _, f in stamped]


# passed validations, path -> (inode, mtime_ns, size): a poll-rate reader
# pays one stat for an unchanged generation.  Only passes are cached; a
# file rewritten in place has a new key and is validated again.
_VALIDATED = {}
_VALIDATED_CAP = 64


def _stat_key(path: str):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_ino, st.st_mtime_ns, st.st_size)


def validate(path: str) -> Optional[str]:
    """None when the checkpoint at ``path`` is healthy, else a reason:
    the npz opens, every member decompresses (the zip CRC), the meta
    parses, and each array's shape is the one the meta recorded.  Passes
    are cached on the file's (inode, mtime, size)."""
    key = _stat_key(path)
    if key is not None and _VALIDATED.get(path) == key:
        return None
    with _tracing.span("checkpoint_validate", path=path):
        reason = _validate(path)
    if reason is None and key is not None and key == _stat_key(path):
        # cache only a pass of the bytes that were read
        if len(_VALIDATED) >= _VALIDATED_CAP:
            _VALIDATED.pop(next(iter(_VALIDATED)))
        _VALIDATED[path] = key
    return reason


def _validate(path: str) -> Optional[str]:
    try:
        data = np.load(path)
    except Exception as e:
        return f"unreadable npz ({type(e).__name__}: {e})"
    if not hasattr(data, "files"):
        # a bare .npy loads as an ndarray, which has no close()
        return "not an npz archive"
    try:
        if "_meta" in data.files:
            meta = json.loads(str(data["_meta"]))
        else:
            with open(path + ".json") as f:
                meta = json.load(f)
        if not isinstance(meta.get("round"), int):
            return "meta carries no integer 'round'"
        arrays = {name: data[name] for name in data.files
                  if name != "_meta"}  # full decompression = CRC check
        if "w" not in arrays:
            return "archive carries no 'w' array"
        for name, shape in (meta.get("shapes") or {}).items():
            if name not in arrays:
                return f"array {name!r} recorded in meta is missing"
            if list(arrays[name].shape) != list(shape):
                return (f"array {name!r} has shape "
                        f"{list(arrays[name].shape)}, meta recorded "
                        f"{list(shape)}")
    except Exception as e:
        return f"corrupt ({type(e).__name__}: {e})"
    finally:
        data.close()
    return None


def latest(directory: str, algorithm: str) -> Optional[str]:
    """The newest healthy checkpoint of ``algorithm``, or None: each
    generation is validated newest first, and a torn or corrupt one is
    skipped with a ``checkpoint_corrupt`` event and a note on stderr."""
    for path in reversed(generations(directory, algorithm)):
        reason = validate(path)
        if reason is None:
            return path
        _events.get_bus().emit(
            "checkpoint_corrupt", algorithm=algorithm.replace(" ", "_"),
            path=path, reason=reason)
        print(f"checkpoint: {path} failed validation ({reason}); "
              f"falling back to the previous generation",
              file=sys.stderr, flush=True)
    return None


def load(path: str):
    """(meta, w, alpha or None), as :func:`load_full` reads them."""
    meta, arrays = load_full(path)
    return meta, arrays["w"], arrays.get("alpha")


def load_full(path: str):
    """(meta, {array name: array}): every array the checkpoint carries,
    ``hist`` included, as host numpy arrays, a bfloat16 one as a bfloat16
    tensor.  The meta comes from inside the archive, or from the sidecar
    for a checkpoint without it."""
    with np.load(path) as data:
        if "_meta" in data.files:
            meta = json.loads(str(data["_meta"]))
        else:
            with open(path + ".json") as f:
                meta = json.load(f)
        return meta, {name: _from_file(data[name]) for name in data.files
                      if name != "_meta"}
