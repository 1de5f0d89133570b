"""Fleet manifests and stacked multi-tenant datasets (counterpart of
cocoa_tpu/data/fleet.py).

A ``--fleet`` manifest (one tenant per JSONL line after a
``fleet_manifest`` header, validated by telemetry/schema.py as its own
dialect) is loaded into a :class:`FleetDataset` whose tensors carry a
leading tenant axis: ``(T, K, n_shard, ...)`` slabs, each tenant's built
by :func:`cocoa_torch.data.sharding.shard_dataset` on the dense layout,
so a tenant's slab is bit for bit the shards a solo run of that tenant
trains on.

Static-shape contract, as in the JAX package: every tenant pads to the
common ``n_shard`` (the fleet's largest shard, rows masked: never
sampled, 0 in every masked sum) and must agree on d, the dense layout,
H and the loss; a tenant that cannot is rejected with the numbers.
Unlike the JAX package the common ``n_shard`` is not rounded up to a
multiple of 16 (the port pads no solo shard either), so a one-tenant
fleet has its solo run's shapes.

What may vary per tenant: the dataset, lambda and the duality-gap
target.  Dataset refs: ``synth:dense:n=<rows>,d=<features>[,seed=S]
[,flip=F]`` generates a planted-separator tenant (data/synth.py), or a
LIBSVM file path (the manifest line then needs ``num_features``).  Each
distinct ref is parsed once a fleet, and each tenant holds its own copy
of its slab, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from cocoa_torch.data.sharding import ShardedDataset, shard_dataset, \
    split_sizes
from cocoa_torch.device import resolve_device


@dataclasses.dataclass
class TenantSpec:
    """One manifest line: a tenant's problem definition."""

    tenant: str                       # unique tenant id
    dataset: str                      # synth:... spec or a LIBSVM path
    lam: float                        # lambda, the tenant's regularization
    gap_target: Optional[float] = None  # duality-gap certificate target
    num_features: int = 0             # required for file-backed datasets
    loss: str = "hinge"               # must be uniform across the fleet
    smoothing: float = 1.0            # must be uniform across the fleet


def parse_dataset_ref(ref: str, num_features: int = 0):
    """A manifest ``dataset`` ref -> :class:`LibsvmData`, with the JAX
    package's rules and messages (cocoa_tpu/data/fleet.py:61-103)."""
    if ref.startswith("synth:"):
        parts = ref.split(":")
        if len(parts) != 3 or parts[1] != "dense":
            raise ValueError(
                f"fleet dataset ref {ref!r}: synth refs are "
                f"'synth:dense:n=<rows>,d=<features>[,seed=S][,flip=F]' "
                f"(sparse tenants are not in the fleet v1 surface — "
                f"docs/DESIGN.md §16)")
        kv = {}
        for item in parts[2].split(","):
            if "=" not in item:
                raise ValueError(
                    f"fleet dataset ref {ref!r}: bad key=value {item!r}")
            key, val = item.split("=", 1)
            kv[key] = val
        try:
            n = int(kv.pop("n"))
            d = int(kv.pop("d"))
            seed = int(kv.pop("seed", 0))
            flip = float(kv.pop("flip", 0.02))
        except (KeyError, ValueError) as e:
            raise ValueError(
                f"fleet dataset ref {ref!r}: needs integer n= and d= "
                f"(optional seed=, flip=): {e}") from None
        if kv:
            raise ValueError(
                f"fleet dataset ref {ref!r}: unknown keys {sorted(kv)}")
        from cocoa_torch.data.synth import synth_dense

        return synth_dense(n, d, seed=seed, flip=flip)
    if num_features <= 0:
        raise ValueError(
            f"fleet dataset ref {ref!r} is a LIBSVM path; the manifest "
            f"line must carry a positive num_features")
    from cocoa_torch.data.libsvm import load_libsvm

    return load_libsvm(ref, num_features)


def load_fleet_manifest(path: str) -> list:
    """Parse and validate a ``--fleet`` manifest into TenantSpecs: the
    file is first checked as the ``fleet`` dialect
    (telemetry/schema.py), and any violation, a duplicate tenant id
    included, is raised with the checker's line-accurate messages."""
    from cocoa_torch.telemetry import schema as tele_schema

    errs = tele_schema.check_file(path, kind="fleet")
    if errs:
        raise ValueError(
            f"fleet manifest {path} failed schema validation "
            f"({len(errs)} violation(s)): " + "; ".join(errs[:5]))
    specs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "fleet_manifest" in obj:
                continue
            specs.append(TenantSpec(
                tenant=str(obj["tenant"]),
                dataset=str(obj["dataset"]),
                lam=float(obj["lam"]),
                gap_target=(None if obj.get("gap_target") is None
                            else float(obj["gap_target"])),
                num_features=int(obj.get("num_features", 0)),
                loss=str(obj.get("loss", "hinge")),
                smoothing=float(obj.get("smoothing", 1.0)),
            ))
    if not specs:
        raise ValueError(f"fleet manifest {path} names no tenants")
    return specs


def write_fleet_manifest(path: str, specs: list) -> None:
    """Write TenantSpecs as a schema-valid fleet manifest: the header,
    then one tenant line each, in the JAX package's layout."""
    with open(path, "w") as f:
        f.write(json.dumps(
            {"fleet_manifest": {"version": 1, "tenants": len(specs)}})
            + "\n")
        for s in specs:
            row = {"tenant": s.tenant, "dataset": s.dataset, "lam": s.lam,
                   "gap_target": s.gap_target}
            if s.num_features:
                row["num_features"] = s.num_features
            if s.loss != "hinge":
                row["loss"] = s.loss
                row["smoothing"] = s.smoothing
            f.write(json.dumps(row) + "\n")


def synth_fleet_specs(tenants: int, *, n: int = 128, d: int = 64,
                      lam_lo: float = 1e-3, lam_hi: float = 1e-1,
                      gap_target: float = 1e-3, seed0: int = 100) -> list:
    """T synthetic tenants along a log-spaced lambda path, each its own
    problem (seed ``seed0 + i``)."""
    lams = np.logspace(np.log10(lam_lo), np.log10(lam_hi), max(tenants, 1))
    return [
        TenantSpec(
            tenant=f"tenant-{i:04d}",
            dataset=f"synth:dense:n={n},d={d},seed={seed0 + i}",
            lam=float(lams[i]),
            gap_target=float(gap_target),
        )
        for i in range(tenants)
    ]


@dataclasses.dataclass
class FleetDataset:
    """T tenants' dense shards stacked on a leading tenant axis, on one
    device.  ``counts[t, k]`` is tenant t's real rows in shard k (rows past
    them are padding, masked everywhere); ``lams`` and ``gap_targets``
    (NaN: none) are the tenants' problem scalars, float64 on the host."""

    tenants: list                     # T tenant id strings
    n: np.ndarray                     # (T,) real example counts
    num_features: int                 # d, common
    counts: np.ndarray                # (T, K) int64
    lams: np.ndarray                  # (T,) float64
    gap_targets: np.ndarray           # (T,) float64, NaN = none
    local_iters: int                  # H, common
    loss: str
    smoothing: float
    labels: torch.Tensor              # (T, K, n_shard)
    mask: torch.Tensor                # (T, K, n_shard)
    sq_norms: torch.Tensor            # (T, K, n_shard)
    X: torch.Tensor                   # (T, K, n_shard, d)
    layout: str = "dense"

    @property
    def t(self) -> int:
        return self.labels.shape[0]

    @property
    def k(self) -> int:
        return self.labels.shape[1]

    @property
    def n_shard(self) -> int:
        return self.labels.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.labels.dtype

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def own_rows(self, t: int) -> int:
        """Tenant t's own shard length: its largest shard, the n_shard of
        its solo run."""
        return int(self.counts[t].max())

    def shard_arrays(self) -> dict:
        """The (T, K, ...) tensors the fleet's rounds read."""
        return {"labels": self.labels, "mask": self.mask,
                "sq_norms": self.sq_norms, "X": self.X}

    def tenant_ds(self, t: int) -> ShardedDataset:
        """Tenant t's slab as a solo :class:`ShardedDataset`, cut to its
        own shard length: the tensors its solo run would build, so a solo
        control trains on bit for bit the data the fleet lane holds."""
        m = self.own_rows(t)

        def own(x):
            return x[t, :, :m].contiguous()

        return ShardedDataset(
            layout="dense", n=int(self.n[t]),
            num_features=self.num_features,
            counts=np.asarray(self.counts[t], dtype=np.int64),
            labels=own(self.labels), mask=own(self.mask),
            sq_norms=own(self.sq_norms), X=own(self.X))


def _stack(parts: list, n_shard: int, key: str) -> torch.Tensor:
    """The tenants' (K, rows, ...) tensors ``key`` zero-padded to
    ``n_shard`` rows and stacked: (T, K, n_shard, ...)."""
    first = getattr(parts[0], key)
    out = torch.zeros((len(parts), first.shape[0], n_shard,
                       *first.shape[2:]), dtype=first.dtype,
                      device=first.device)
    for ti, ds in enumerate(parts):
        src = getattr(ds, key)
        out[ti, :, :src.shape[1]].copy_(src)
    return out


def _gap_array(gap_targets) -> np.ndarray:
    return np.asarray([np.nan if g is None else float(g)
                       for g in gap_targets], dtype=np.float64)


def fleet_from_datasets(datasets: list, lams, gap_targets=None,
                        tenants=None, local_iters: int = 1,
                        loss: str = "hinge",
                        smoothing: float = 1.0) -> FleetDataset:
    """Stack already-built solo :class:`ShardedDataset` objects into a
    fleet: all must share the dense layout, one device and one
    (K, n_shard, d) shape; ``lams`` is the per-tenant lambda,
    ``gap_targets`` per tenant or None, ``local_iters`` the common H."""
    if not datasets:
        raise ValueError("fleet_from_datasets needs at least one dataset")
    shapes = sorted({(d.layout, d.k, d.n_shard, d.num_features)
                     for d in datasets})
    if len(shapes) > 1 or shapes[0][0] != "dense":
        raise ValueError(
            f"fleet datasets must share one dense (K, n_shard, d) static "
            f"shape; got {shapes} — pad to a common shape or split the "
            f"fleet (sparse tenants are not in the fleet v1 surface)")
    t_count = len(datasets)
    lams = np.asarray(lams, dtype=np.float64)
    if lams.shape != (t_count,):
        raise ValueError(f"lams must be one λ per tenant "
                         f"({t_count}), got shape {lams.shape}")
    gaps = (np.full(t_count, np.nan) if gap_targets is None
            else _gap_array(gap_targets))
    return FleetDataset(
        tenants=(list(tenants) if tenants is not None
                 else [f"tenant-{i:04d}" for i in range(t_count)]),
        n=np.array([d.n for d in datasets], dtype=np.int64),
        num_features=datasets[0].num_features,
        counts=np.stack([np.asarray(d.counts) for d in datasets]
                        ).astype(np.int64),
        lams=lams, gap_targets=gaps, local_iters=int(local_iters),
        loss=loss, smoothing=float(smoothing),
        labels=torch.stack([d.labels for d in datasets]),
        mask=torch.stack([d.mask for d in datasets]),
        sq_norms=torch.stack([d.sq_norms for d in datasets]),
        X=torch.stack([d.X for d in datasets]),
    )


def build_fleet(specs: list, k: int, *, dtype: torch.dtype = torch.float32,
                local_iter_frac: float = 1.0,
                default_gap_target: Optional[float] = None,
                device=None) -> FleetDataset:
    """Stack the tenants of ``specs`` into one :class:`FleetDataset` on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for), enforcing the
    static-shape contract with the JAX package's messages
    (cocoa_tpu/data/fleet.py:290-397): one loss phase, one d, one
    H = max(1, localIterFrac*n/K), and every shard non-empty; n may vary
    and the shards pad to the fleet's largest.  Each distinct (ref,
    num_features) is parsed and sharded once."""
    device = resolve_device(device)
    if not specs:
        raise ValueError("build_fleet needs at least one tenant")
    losses_seen = sorted({(s.loss, float(s.smoothing)) for s in specs})
    if len(losses_seen) > 1:
        raise ValueError(
            f"fleet tenants must share one loss phase (a per-tenant loss "
            f"would make every vmapped lane pay every branch); manifest "
            f"mixes {losses_seen} — split the fleet by loss")
    memo: dict = {}
    parsed = []
    for s in specs:
        key = (s.dataset, int(s.num_features))
        if key not in memo:
            memo[key] = parse_dataset_ref(s.dataset, s.num_features)
        parsed.append(memo[key])
    ds_d = sorted({p.num_features for p in parsed})
    if len(ds_d) > 1:
        raise ValueError(
            f"fleet tenants must share one feature dimension d (the "
            f"stacked (T, K, n_shard, d) slab is one static shape); "
            f"manifest mixes d={ds_d}")
    hs = {}
    for s, p in zip(specs, parsed):
        hs.setdefault(max(1, int(local_iter_frac * p.n / k)),
                      []).append(s.tenant)
    if len(hs) > 1:
        raise ValueError(
            f"fleet tenants must share one H = max(1, localIterFrac·n/K) "
            f"(the index-table width is one static shape); manifest "
            f"yields H={ {h: v[:3] for h, v in sorted(hs.items())} } — "
            f"pad tenant datasets to a common n or split the fleet")
    sizes = [split_sizes(p.n, k) for p in parsed]
    for s, p, sz in zip(specs, parsed, sizes):
        if np.any(sz <= 0):
            raise ValueError(
                f"fleet tenant {s.tenant!r}: every shard needs at least "
                f"one example; n={p.n} over K={k} shards gives sizes "
                f"{sz.tolist()} — lower numSplits")
    n_shard = int(max(int(sz.max()) for sz in sizes))
    slabs = {}
    parts = []
    for s in specs:
        key = (s.dataset, int(s.num_features))
        if key not in slabs:
            slabs[key] = shard_dataset(memo[key], k=k, layout="dense",
                                       dtype=dtype, device=device)
        parts.append(slabs[key])
    gaps = _gap_array([s.gap_target if s.gap_target is not None
                       else default_gap_target for s in specs])
    return FleetDataset(
        tenants=[s.tenant for s in specs],
        n=np.array([p.n for p in parsed], dtype=np.int64),
        num_features=ds_d[0],
        counts=np.stack(sizes).astype(np.int64),
        lams=np.array([s.lam for s in specs], dtype=np.float64),
        gap_targets=gaps,
        local_iters=next(iter(hs)),
        loss=specs[0].loss,
        smoothing=float(specs[0].smoothing),
        labels=_stack(parts, n_shard, "labels"),
        mask=_stack(parts, n_shard, "mask"),
        sq_norms=_stack(parts, n_shard, "sq_norms"),
        X=_stack(parts, n_shard, "X"),
    )
