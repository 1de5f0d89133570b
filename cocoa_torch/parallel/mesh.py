"""The gang's mesh (counterpart of cocoa_tpu/parallel/mesh.py): the dp
axis, the fp axis and the fleet's tenant axis.

In the JAX package a mesh is a set of devices, possibly of one process.
Here it is the process group, one rank a device.  On the dp axis rank r
holds the m = K/D consecutive logical shards [p*m, (p+1)*m) of its dp
position p and runs them as the single-process path runs all K; the
round's dw is summed across the dp positions by one all-reduce
(parallel/fanout.py).  ``--fp=F`` makes the gang K x F ranks: rank r sits
at dp position r // F and fp slice f = r % F, holds the column block
[f*d_pad/F, (f+1)*d_pad/F) of its shards' rows and of w, and sums every
d-contraction (a step's x.dw, the round's X.w0, the block's Gram and
margin base, the eval's margins and |w|^2) over its F peers (``fp_sum``),
where GSPMD inserts the same collectives for the JAX package's auto fp
axis.  A single process with no ``--master`` has no mesh (None), which
is the JAX package's ``--mesh=1`` path.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch

from cocoa_torch.parallel import distributed

TENANT_AXIS = "tenant"   # the fleet's spare axis: independent models,
                         # not shards; no collective ever crosses it


class Mesh:
    """The gang as the solvers see it: this process's ``rank`` of
    ``size``, its ``device``, the ``backend`` of its device group (nccl
    or gloo), and ``device_group``, the world's device group (None: the
    default world group, gloo, which also carries the host traffic).

    ``fp`` > 1 splits the world into a (dp, fp) grid, rank = dp_rank * fp
    + fp_rank: ``dp_group`` holds the ranks of this rank's fp slice (one
    per dp position: the round's dw and the eval's sums), ``fp_group``
    the ranks of its dp position (its F column blocks: the partial dots).
    With fp = 1 the dp group is the device group and there is no fp
    group."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, device_group=None, fp: int = 1,
                 dp_group=None, fp_group=None):
        if fp < 1 or size % fp != 0:
            raise ValueError(f"a mesh of {size} ranks has no fp axis of "
                             f"{fp}")
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.device_group = device_group
        self.fp = fp
        self.dp_rank, self.fp_rank = divmod(rank, fp)
        self.dp_size = size // fp
        self.dp_group = device_group if fp == 1 else dp_group
        self.fp_group = fp_group

    @property
    def capturable(self) -> bool:
        """Whether the device group's collectives can sit inside a
        captured CUDA graph: NCCL can be captured, gloo cannot."""
        return self.device.type == "cuda" and self.backend == "nccl"

    def describe(self) -> str:
        out = (f"rank {self.rank} of {self.size} on {self.device}, device "
               f"group {self.backend}")
        if self.fp > 1:
            out += (f", dp position {self.dp_rank} of {self.dp_size}, fp "
                    f"slice {self.fp_rank} of {self.fp}")
        return out


def has_fp(mesh) -> bool:
    """True when the mesh carries a feature-parallel axis (F > 1)."""
    return mesh is not None and getattr(mesh, "fp", 1) > 1


def _device_groups(world: int, fp: int, rank: int, backend: str):
    """(dp_group, fp_group) of ``rank`` in a (world/fp, fp) grid.  Every
    rank creates every group, dp slices first, in the same order, as
    ``new_group`` requires; each keeps the two it belongs to."""
    k = world // fp
    dp_group = fp_group = None
    for f in range(fp):
        g = torch.distributed.new_group([p * fp + f for p in range(k)],
                                        backend=backend)
        if rank % fp == f:
            dp_group = g
    for p in range(k):
        g = torch.distributed.new_group([p * fp + f for f in range(fp)],
                                        backend=backend)
        if rank // fp == p:
            fp_group = g
    return dp_group, fp_group


def make_mesh(k: Optional[int] = None, device="cuda", fp: int = 1) -> Mesh:
    """The (dp,) or (dp, fp) mesh over the gang that
    :func:`distributed.maybe_initialize` joined: ``k`` dp positions
    (default: every rank over ``fp``) by ``fp`` column slices, one rank
    each, each on ``cuda:(rank % cards)`` unless ``device`` is the CPU;
    the world must be k * fp ranks.  The ranks post their (host, card)
    pairs over the host group and pick the device groups' backend from
    them (:func:`distributed.device_backend`; two ranks sharing a card
    use gloo); an NCCL group is set up and used once here, so a failure
    raises now."""
    if not distributed.initialized():
        raise ValueError("a dp mesh needs the gang: --master=host:port with "
                         "--processId and --numProcesses")
    world = torch.distributed.get_world_size()
    if k is None:
        k = world // fp
    if k * fp != world:
        raise ValueError(f"mesh ({k} dp x {fp} fp) needs {k * fp} devices, "
                         f"have {world}")
    rank = torch.distributed.get_rank()
    dev = distributed.rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = distributed.device_backend(distributed.post_device(dev),
                                         dev.type == "cuda")
    group = dp_group = fp_group = None
    if fp > 1:
        dp_group, fp_group = _device_groups(world, fp, rank, backend)
    if backend == "nccl":
        if fp == 1:
            group = dp_group = torch.distributed.new_group(backend="nccl")
        for g, n in ((dp_group, k), (fp_group, fp)):
            if g is None:
                continue
            probe = torch.ones(1, device=dev)
            torch.distributed.all_reduce(probe, group=g)
            if int(probe.item()) != n:
                raise RuntimeError(f"the NCCL device group's first "
                                   f"all-reduce gave {probe.item()}, "
                                   f"expected {n}")
    return Mesh(rank, world, dev, backend, device_group=group, fp=fp,
                dp_group=dp_group, fp_group=fp_group)


def dp_local_shards(mesh: Mesh, k: int) -> list:
    """``[(device, shard_lo, shard_hi)]`` for THIS process's dp position
    p: the m = K/D consecutive logical shards [p*m, (p+1)*m), the
    multiplexing contract :func:`cocoa_torch.parallel.fanout.
    shards_per_device` runs the solvers under (D the dp size; the F ranks
    of a dp position hold the same shards)."""
    d = mesh.dp_size
    if k % d != 0:
        raise ValueError(
            f"{k} shards cannot multiplex evenly onto the {d}-device dp "
            f"axis; K must be a multiple of the mesh size (the elastic "
            f"supervisor's shrink path only ever reforms gangs whose "
            f"device count divides K — elastic.shrink_gang_size)"
        )
    m = k // d
    return [(mesh.device, mesh.dp_rank * m, (mesh.dp_rank + 1) * m)]


def local_part(mesh: Optional[Mesh]) -> Optional[tuple]:
    """(dp position, dp size) for the shard builders' ``part``, None
    without a mesh."""
    return None if mesh is None else (mesh.dp_rank, mesh.dp_size)


def feature_part(mesh: Optional[Mesh]) -> Optional[tuple]:
    """(fp slice, F) for the shard builders' ``cols``, None without an fp
    axis."""
    return (mesh.fp_rank, mesh.fp) if has_fp(mesh) else None


def pad_features(d: int, mesh) -> int:
    """d rounded up to an fp-and-sublane multiple, the JAX package's rule
    (cocoa_tpu/parallel/mesh.py ``pad_features``): lcm(F, 8).  The fp
    column split needs equal blocks; zero pad columns touch nothing, and
    w's matching entries stay exactly 0."""
    return padded_width(d, mesh.fp if has_fp(mesh) else 1)


def padded_width(d: int, fp: int) -> int:
    """:func:`pad_features` for an fp axis of ``fp`` slices."""
    m = math.lcm(fp, 8)
    return -(-d // m) * m


def column_block(d_pad: int, cols: tuple) -> tuple:
    """[lo, hi) of fp slice f of F over ``d_pad`` columns,
    ``cols=(f, F)``."""
    f, fp = cols
    if fp < 1 or not 0 <= f < fp or d_pad % fp:
        raise ValueError(f"cols must be (slice, F) with 0 <= slice < F "
                         f"and F dividing {d_pad}, got {cols}")
    width = d_pad // fp
    return f * width, (f + 1) * width


# --- fleet: regex-rule partition specs over the tenant axis -----------------
#
# The fleet path (solvers/fleet.py) stacks T independent tenants on a
# leading axis of every state and data leaf.  Placement is an ordered
# list of (regex, PartitionSpec) rules matched against each leaf's
# '/'-joined tree path, first match wins (cocoa_tpu/parallel/mesh.py:
# 161-237).  In torch a spec names, per dimension, the mesh axis that
# splits it; a leaf's tenant rule picks the rank's slice of its leading
# axis (:class:`TenantSharding`).


class PartitionSpec(tuple):
    """A leaf's placement: one mesh axis name (or None, replicated) per
    leading dimension, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _tree_paths(tree, prefix=()):
    """(path, leaf) of every leaf of a tree of dicts, lists and tuples,
    in JAX's order (a dict's keys sorted)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tree_paths(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, PartitionSpec):
        for i, item in enumerate(tree):
            yield from _tree_paths(item, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _tree_map(fn, tree, prefix=()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``, visited in
    JAX's order (a dict's keys sorted)."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, tree[key], prefix + (str(key),))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, PartitionSpec):
        return type(tree)(_tree_map(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else fn("/".join(prefix), tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in JAX's order;
    a PartitionSpec or a :class:`TenantSharding` is a leaf."""
    return [leaf for _, leaf in _tree_paths(tree)]


def match_partition_rules(rules, tree):
    """Map every leaf of ``tree`` to the PartitionSpec of the first rule
    whose regex searches its '/'-joined path.  Raises on an unmatched
    leaf, with the JAX package's words: a silent default is how a new
    state leaf ends up replicated across a thousand tenants."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def assign(name, leaf):
        for pat, spec in compiled:
            if pat.search(name):
                return spec
        raise ValueError(
            f"no partition rule matches tree path {name!r}; add a rule "
            f"(the catch-all '.*' usually belongs at the end)")

    return _tree_map(assign, tree)


def fleet_partition_rules(tree) -> tuple:
    """The fleet rule set: every leaf with a leading tenant axis shards
    that axis; per-tenant scalars ((T,) leaves) likewise."""
    del tree  # one rule covers the whole fleet state/data surface today
    return ((r".*", P(TENANT_AXIS)),)


class TenantMesh:
    """A 1-axis ``tenant`` mesh: ``size`` ranks, this process at
    ``rank``; each holds T/size consecutive tenants of every fleet
    leaf."""

    axis_names = (TENANT_AXIS,)

    def __init__(self, size: int, rank: int = 0):
        self.size, self.rank = size, rank


def make_fleet_mesh(t_devices: Optional[int] = None,
                    devices: Optional[int] = None) -> TenantMesh:
    """The tenant mesh over ``t_devices`` ranks of the ``devices`` there
    are (default: the gang's world, 1 without one), with the JAX
    package's message when they are too few.  ``t_devices=1`` is the
    degenerate single-card control: every tenant on this rank."""
    world = (torch.distributed.get_world_size()
             if distributed.initialized() else 1)
    devices = world if devices is None else int(devices)
    t_devices = devices if t_devices is None else int(t_devices)
    if t_devices > devices:
        raise ValueError(f"fleet mesh needs {t_devices} devices, have "
                         f"{devices}")
    rank = (torch.distributed.get_rank() if distributed.initialized()
            else 0)
    return TenantMesh(t_devices, rank % t_devices)


class TenantSharding:
    """A leaf's placement on a :class:`TenantMesh`: ``spec`` and the
    rank's ``index`` (a slice of the leading axis, or every row when the
    spec names no tenant axis)."""

    def __init__(self, mesh: TenantMesh, spec: PartitionSpec, rows: int):
        self.mesh, self.spec = mesh, spec
        if spec and spec[0] == TENANT_AXIS:
            if rows % mesh.size:
                raise ValueError(f"{rows} tenants cannot split evenly over "
                                 f"the {mesh.size}-rank tenant axis")
            m = rows // mesh.size
            self.index = slice(mesh.rank * m, (mesh.rank + 1) * m)
        else:
            self.index = slice(None)

    def apply(self, leaf):
        """This rank's slice of ``leaf``."""
        return leaf[self.index]


def fleet_shardings(mesh: TenantMesh, tree):
    """A :class:`TenantSharding` for every leaf of a fleet tree, from the
    rule set: the placement map for state, shard slabs and per-tenant
    scalars."""
    specs = match_partition_rules(fleet_partition_rules(tree), tree)
    leaves = dict(_tree_paths(tree))
    return _tree_map(lambda name, spec: TenantSharding(
        mesh, spec, len(leaves[tuple(name.split("/"))])), specs)
