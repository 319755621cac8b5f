"""The rank layout of a data x fsdp x pipe x seq x expert x model mesh and
its sub-groups (the degrees -> groups part of ``tpuframe/parallel/mesh.py``).

The JAX package lays its devices out row-major over its axes (``AXES``:
data, fsdp, pipe, seq, expert, model), data outermost, and a collective
over an axis runs among the devices that differ in that coordinate only.
Here a rank plays a device: rank ``r`` is row-major over the same axes
(:func:`rank_of`; the trainer refuses slices).  Each sub-group gets its
own ``torch.distributed`` group, made by :func:`build` on every rank in
the same order:

  - a **seq ring** (the ranks that differ in their seq coordinate only)
    with a seq degree above 1, for ring attention and Ulysses;
  - with an fsdp, expert or model degree above 1 (the JAX trainer's
    sharded-state mode): the **fsdp** group (the ranks that hold the
    other fsdp blocks of a leaf: its gathers and reduce-scatters,
    ``parallel/fsdp.py``), the **model** group (tensor parallelism), the
    **expert** group (expert parallelism), the **shard** group (expert x
    model, over which an MoE layer's partial outputs are summed), the
    **data** group (the ranks that hold the same block of every leaf and
    other batch rows: an fsdp-split leaf's gradient is averaged over it)
    and the **batch** group (data x fsdp: every rank that takes other
    rows and holds the same expert and model blocks; the group a leaf
    that is whole over fsdp is averaged over, the loss's and the
    metrics' means run over, and global MoE routing counts tokens over).

The batch's rows shard over data x fsdp (the JAX ``BATCH_AXES``): rank
``(d, f)`` takes row block ``d * fsdp + f`` (:attr:`Layout.batch_index`),
and ranks that differ only in their pipe, seq, expert or model coordinate
take the same rows (a seq rank its block of their columns).  A world of one, or a degree of 1, has no group for that axis;
a batch group with the ranks of the data or the fsdp group is that group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

# the JAX package's axis order, data outermost
AXES = ("data", "fsdp", "pipe", "seq", "expert", "model")
SHARD_AXES = ("expert", "model")
# the axes a leaf's blocks are split over in the sharded-state mode
STATE_AXES = ("fsdp", "expert", "model")
BATCH_AXES = ("data", "fsdp")


@dataclass(frozen=True)
class Group:
    """A sub-group of the mesh: its ``torch.distributed`` group, its size,
    this rank's place in it (``index``) and its members' world ranks in
    order."""

    group: object
    size: int
    index: int
    ranks: tuple


# a seq ring is one such group (its index the seq coordinate)
SeqGroup = Group


@dataclass(frozen=True)
class Layout:
    """A rank's place in the mesh: every axis's degree (``sizes``, as
    ``MeshSpec.sizes`` gives them), the rank, and its groups (None where
    the axis has a degree of 1, and for fsdp, expert, model, shard, data
    and batch outside the sharded-state and pipeline modes)."""

    sizes: dict
    rank: int
    seq: Group | None = None
    pipe: Group | None = None
    fsdp: Group | None = None
    expert: Group | None = None
    model: Group | None = None
    shard: Group | None = None
    data: Group | None = None
    batch: Group | None = None

    def coords(self) -> dict:
        """This rank's coordinate on every axis."""
        out, r = {}, self.rank
        for axis in reversed(AXES):
            n = self.sizes.get(axis, 1)
            out[axis] = r % n
            r //= n
        return out

    @property
    def sharded(self) -> bool:
        """The JAX trainer's sharded-state mode: an fsdp, expert or model
        degree above 1."""
        return any(self.sizes.get(a, 1) > 1 for a in STATE_AXES)

    @property
    def data_size(self) -> int:
        """The data degree (the ranks that hold the same blocks)."""
        return self.sizes["data"]

    @property
    def data_index(self) -> int:
        return self.coords()["data"]

    @property
    def data_group(self):
        """The data group as a ``torch.distributed`` group (None for a
        data degree of 1)."""
        return None if self.data is None else self.data.group

    @property
    def batch_size(self) -> int:
        """The degree the batch's rows are split over: data x fsdp."""
        return self.sizes["data"] * self.sizes.get("fsdp", 1)

    @property
    def batch_index(self) -> int:
        """This rank's row block: data index x fsdp + fsdp index."""
        c = self.coords()
        return c["data"] * self.sizes.get("fsdp", 1) + c["fsdp"]

    @property
    def batch_group(self):
        """The batch group as a ``torch.distributed`` group (None for a
        batch degree of 1)."""
        return None if self.batch is None else self.batch.group

    @property
    def pipe_size(self) -> int:
        """The pipe degree: the pipeline's stages."""
        return self.sizes.get("pipe", 1)

    @property
    def pipe_index(self) -> int:
        """This rank's stage."""
        return self.coords()["pipe"]

    @property
    def seq_size(self) -> int:
        return self.sizes["seq"]

    @property
    def seq_index(self) -> int:
        return self.coords()["seq"]


def rank_of(sizes: dict, coords: dict) -> int:
    """The world rank at ``coords`` (row-major over :data:`AXES`)."""
    r = 0
    for axis in AXES:
        r = r * sizes.get(axis, 1) + coords.get(axis, 0)
    return r


def axis_groups(sizes: dict, axes: tuple) -> list[tuple]:
    """Every group of ranks that differ only in their coordinates on
    ``axes``, each in row-major order over those axes; the groups in the
    order of their lowest rank."""
    world = 1
    for a in AXES:
        world *= sizes.get(a, 1)
    seen, out = set(), []
    for r in range(world):
        if r in seen:
            continue
        base = Layout(sizes=sizes, rank=r).coords()
        members = [dict(base)]
        for axis in axes:
            members = [dict(m, **{axis: i}) for m in members
                       for i in range(sizes.get(axis, 1))]
        ranks = tuple(rank_of(sizes, m) for m in members)
        seen.update(ranks)
        out.append(ranks)
    return out


def seq_rings(data: int, seq: int) -> list[tuple]:
    """The world ranks of every seq ring, in ring order, by data index
    (a data x seq mesh)."""
    return axis_groups({"data": data, "seq": seq}, ("seq",))


def _groups(sizes: dict, axes: tuple, rank: int) -> Group:
    """Make every group over ``axes`` (collective over the world: every
    rank calls this in the same order) and return this rank's."""
    mine = None
    for ranks in axis_groups(sizes, axes):
        grp = dist.new_group(list(ranks))
        if rank in ranks:
            mine = Group(group=grp, size=len(ranks),
                         index=ranks.index(rank), ranks=ranks)
    return mine


def build(sizes: dict, rank: int) -> Layout:
    """``rank``'s layout on a mesh of ``sizes`` (every axis's degree, the
    world their product).  Makes the seq rings with a seq degree above 1;
    in the sharded-state mode, the fsdp, expert, model, shard, data and
    batch groups whose size is above 1 (a batch group with the ranks of
    the data or the fsdp group is that group); with a pipe degree above
    1, the pipe groups and the data groups (each also the batch group).
    A pipe degree composes with data alone, as the JAX trainer's
    pipeline step does."""
    other = {a: n for a, n in sizes.items() if a not in AXES and n != 1}
    if other:
        raise ValueError(f"the port lays out data x fsdp x pipe x seq x "
                         f"expert x model meshes only; got {other}")
    if sizes.get("pipe", 1) > 1:
        mixed = {a: sizes[a] for a in ("seq", *STATE_AXES)
                 if sizes.get(a, 1) > 1}
        if mixed:
            raise ValueError(f"mesh pipe={sizes['pipe']} with {mixed}: the "
                             f"pipeline composes with data parallelism "
                             f"only")
    world = 1
    for a in AXES:
        world *= sizes.get(a, 1)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} lies outside the mesh {sizes}")
    groups = {}
    if sizes.get("seq", 1) > 1:
        groups["seq"] = _groups(sizes, ("seq",), rank)
    if sizes.get("pipe", 1) > 1:
        groups["pipe"] = _groups(sizes, ("pipe",), rank)
        if sizes["data"] > 1:
            groups["data"] = _groups(sizes, ("data",), rank)
        groups["batch"] = groups.get("data")
    if any(sizes.get(a, 1) > 1 for a in STATE_AXES):
        for name, axes in (("fsdp", ("fsdp",)), ("expert", ("expert",)),
                           ("model", ("model",)), ("shard", SHARD_AXES),
                           ("data", ("data",))):
            n = 1
            for a in axes:
                n *= sizes.get(a, 1)
            if n > 1:
                groups[name] = _groups(sizes, axes, rank)
        if sizes.get("fsdp", 1) == 1:
            groups["batch"] = groups.get("data")
        elif sizes["data"] == 1:
            groups["batch"] = groups["fsdp"]
        else:
            groups["batch"] = _groups(sizes, BATCH_AXES, rank)
    return Layout(sizes=dict(sizes), rank=rank, **groups)
