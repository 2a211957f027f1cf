"""Mesh topology of the distributed frame: the flat mesh, or the
two-level ``(hosts, ranks)`` mesh of the reference's
``parallel/topology.py``.

A ``TopologyConfig(num_hosts, domain_size)`` resolves to a mesh of
``num_hosts`` domains of ``domain_size`` ranks: the *ranks* axis is the
fast intra-domain (ICI) level, the *hosts* axis crosses domains (DCN).
On the port's in-process mesh every rank still runs in turn on one
device, so the hierarchy is emulated, as the reference emulates it on
its virtual CPU mesh; the two-level composite (``parallel/hier.py``)
runs its two levels and its wire codecs as a split across cards would.

Generation is topology-agnostic: it addresses the mesh through the flat
rank order ``Topology.flat_axis``, hosts-major, so flat rank ``h * D +
d`` owns z-slab ``h * D + d`` as on the flat mesh. Only the sort-last
composite reads the split, and it hands out its column blocks in the
ranks-major order ``Topology.out_axis``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from scenery_insitu_tpu_torch import obs as _obs
from scenery_insitu_tpu_torch.config import MeshConfig, TopologyConfig
from scenery_insitu_tpu_torch.device import resolve_device
from scenery_insitu_tpu_torch.parallel.mesh import (DEFAULT_AXIS, Mesh,
                                                    make_mesh)


class Topology(NamedTuple):
    """Resolved topology of a two-level mesh."""

    num_hosts: int          # domains (DCN endpoints)
    domain_size: int        # ranks a domain
    hosts_axis: str         # inter-domain (DCN) axis
    ranks_axis: str         # intra-domain (ICI) axis
    dcn_wire: str = "f32"   # wire format of the DCN hop

    @property
    def n_ranks(self) -> int:
        return self.num_hosts * self.domain_size

    @property
    def flat_axis(self) -> Tuple[str, str]:
        """The generation side's rank order, hosts-major: flat rank ``h
        * D + d`` is the flat mesh's rank of the same number."""
        return (self.hosts_axis, self.ranks_axis)

    @property
    def out_axis(self) -> Tuple[str, str]:
        """The composite's output order: level 1 hands rank ``(h, d)``
        column block ``d`` and level 2 sub-block ``h`` within it, so its
        columns sit at flat position ``d * H + h``, ranks-major."""
        return (self.ranks_axis, self.hosts_axis)


def resolve_topology(cfg: Optional[TopologyConfig], n_devices: int,
                     ranks_axis: str = DEFAULT_AXIS) -> Optional[Topology]:
    """A TopologyConfig against a rank count: None for the flat mesh
    (``num_hosts == 1``). A one-host config that sets ``domain_size``
    asked for a split with nothing to split across: the knob is inert
    and goes on the ledger (``topology.hier``). ``domain_size`` (0 =
    ``n_devices / num_hosts``) must tile the ranks exactly."""
    if cfg is None or cfg.num_hosts == 1:
        if cfg is not None and cfg.domain_size not in (0, n_devices):
            _obs.degrade(
                "topology.hier", f"domain_size={cfg.domain_size}", "flat",
                "num_hosts=1: a single host has no DCN axis — the "
                "two-level composite degenerates to the flat path",
                warn=False)
        return None
    h = cfg.num_hosts
    d = cfg.domain_size or (n_devices // h if n_devices % h == 0 else 0)
    if d <= 0 or n_devices % d or h * d != n_devices:
        raise ValueError(
            f"topology (num_hosts={h}, domain_size={cfg.domain_size}) "
            f"does not tile {n_devices} devices — domain_size must "
            f"divide the device count and num_hosts * domain_size must "
            f"equal it (0 = auto derives {n_devices}/{h})")
    if cfg.hosts_axis == ranks_axis:
        raise ValueError(
            f"hosts_axis {cfg.hosts_axis!r} collides with the ranks "
            f"axis name — the two mesh levels need distinct axes")
    return Topology(num_hosts=h, domain_size=d, hosts_axis=cfg.hosts_axis,
                    ranks_axis=ranks_axis, dcn_wire=cfg.dcn_wire)


def make_topology_mesh(topo_cfg: Optional[TopologyConfig] = None,
                       mesh_cfg: Optional[MeshConfig] = None,
                       device=None) -> Tuple[Mesh, Optional[Topology]]:
    """The rank mesh under a topology: ``(mesh, topo)``, the flat
    `make_mesh` and None for a flat config, else the two-level mesh of
    ``mesh_cfg.num_devices`` in-process ranks (0 = one rank) on
    ``device`` (None means CUDA and raises without a card) and its
    `Topology`."""
    mesh_cfg = mesh_cfg or MeshConfig()
    n = mesh_cfg.num_devices or 1
    topo = resolve_topology(topo_cfg, n, mesh_cfg.axis_name)
    if topo is None:
        return make_mesh(n, device=device, axis_name=mesh_cfg.axis_name), \
            None
    return Mesh(n, resolve_device(device), topo.flat_axis,
                topo.num_hosts), topo


def topology_of(mesh: Mesh, topology: Optional[TopologyConfig] = None
                ) -> Optional[Topology]:
    """The `Topology` of a mesh: None for a flat mesh; for a two-level
    mesh the split read off the mesh itself, cross-checked against
    ``topology`` when one is given (a config that disagrees with its
    mesh is a caller's bug)."""
    names = mesh.axis_names
    if len(names) == 1:
        if topology is not None and topology.num_hosts > 1:
            raise ValueError(
                f"topology requests num_hosts={topology.num_hosts} but "
                f"the mesh is flat 1-D ({names[0]!r}) — build it with "
                f"topology.make_topology_mesh")
        return None
    if len(names) != 2:
        raise ValueError(f"compositing meshes are 1-D (flat) or 2-D "
                         f"(hosts, ranks); got axes {names}")
    hosts_axis, ranks_axis = names
    h, d = mesh.num_hosts, mesh.domain_size
    dcn_wire = "f32"
    if topology is not None and topology.num_hosts > 1:
        if (topology.num_hosts != h
                or (topology.domain_size not in (0, d))
                or topology.hosts_axis != hosts_axis):
            raise ValueError(
                f"topology (num_hosts={topology.num_hosts}, domain_size="
                f"{topology.domain_size}, hosts_axis="
                f"{topology.hosts_axis!r}) disagrees with the mesh "
                f"({hosts_axis!r}={h}, {ranks_axis!r}={d})")
        dcn_wire = topology.dcn_wire
    return Topology(num_hosts=h, domain_size=d, hosts_axis=hosts_axis,
                    ranks_axis=ranks_axis, dcn_wire=dcn_wire)


def resolve_mesh_topology(mesh: Mesh, topology=None):
    """``(axis, n, topo)`` of a mesh, as every step builder resolves it:
    the generation axis (the rank axis's name on a flat mesh, the
    ``(hosts, ranks)`` pair on a two-level one), the total rank count
    and the `Topology` of the two-level composite (None = flat)."""
    topo = topology_of(mesh, topology)
    if topo is None:
        return mesh.axis_names[0], mesh.n, None
    return topo.flat_axis, topo.n_ranks, topo
