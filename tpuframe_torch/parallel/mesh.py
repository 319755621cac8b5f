"""The rank layout of a data x seq mesh and its sequence sub-groups (the
degrees -> groups part of ``tpuframe/parallel/mesh.py``).

The JAX package lays its devices out row-major over its axes, data
outermost, and a collective over the ``seq`` axis runs among the devices
that differ in their ``seq`` coordinate only.  Here a rank plays a
device: of the axes the port runs (data and seq; the trainer refuses every
other), rank ``r`` is ``data_idx * seq + seq_idx``.  Each seq ring (the
ranks of one data index) gets its own ``torch.distributed`` group, made
by :func:`build` on every rank in the same order, so that the ring's
collectives never share a group with the gradient reduction, which stays
on the world: the parameters are replicated over both axes, as in the
JAX step.

A world of one, or a seq degree of 1, has no seq group: the model then
runs whole-sequence attention.  The trainer hands its layout's ring to
the model it builds (``TransformerLM.seq``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class SeqGroup:
    """One seq ring: its group, its size, this rank's place in it
    (``index``, the seq coordinate) and its members' world ranks in ring
    order."""

    group: object
    size: int
    index: int
    ranks: tuple


@dataclass(frozen=True)
class Layout:
    """A rank's place in the mesh: every axis's degree (``sizes``, as
    ``MeshSpec.sizes`` gives them; all but data and seq are 1), the rank
    and its seq ring (None with a seq degree of 1)."""

    sizes: dict
    rank: int
    seq: SeqGroup | None = None

    @property
    def data_size(self) -> int:
        """The degree the batch's rows are split over."""
        return self.sizes["data"]

    @property
    def data_index(self) -> int:
        return self.rank // self.seq_size

    @property
    def seq_size(self) -> int:
        return self.sizes["seq"]

    @property
    def seq_index(self) -> int:
        return self.rank % self.seq_size


def seq_rings(data: int, seq: int) -> list[tuple]:
    """The world ranks of every seq ring, in ring order, by data index."""
    return [tuple(range(d * seq, (d + 1) * seq)) for d in range(data)]


def build(sizes: dict, rank: int) -> Layout:
    """``rank``'s layout on a mesh of ``sizes`` (every axis's degree, the
    world their product).  With a seq degree above 1 every rank makes
    every ring's group (``dist.new_group`` is collective over the world)
    and keeps its own."""
    other = {a: n for a, n in sizes.items()
             if a not in ("data", "seq") and n != 1}
    if other:
        raise ValueError(f"the port lays out data x seq meshes only; got "
                         f"{other}")
    data, seq = sizes["data"], sizes["seq"]
    if not 0 <= rank < data * seq:
        raise ValueError(f"rank {rank} lies outside the mesh {sizes}")
    mine = None
    if seq > 1:
        for ranks in seq_rings(data, seq):
            grp = dist.new_group(list(ranks))
            if rank in ranks:
                mine = SeqGroup(group=grp, size=seq,
                                index=ranks.index(rank), ranks=ranks)
    return Layout(sizes=dict(sizes), rank=rank, seq=mine)
