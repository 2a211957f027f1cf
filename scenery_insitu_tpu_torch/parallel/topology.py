"""Mesh topology of the distributed frame: the flat part of the
reference's ``parallel/topology.py``.

The port's meshes are flat 1-D rank meshes (``parallel/mesh.py``). The
reference's two-level (hosts, ranks) composite across domains is ROADMAP
A8b; a topology asking for it raises here.
"""

from __future__ import annotations

from typing import Tuple

from scenery_insitu_tpu_torch.parallel.mesh import Mesh


def resolve_mesh_topology(mesh: Mesh, topology=None) -> Tuple[str, int, None]:
    """``(axis, n, topo)`` of a mesh: the rank axis, the rank count and
    the two-level topology, which is always None (flat) here.
    ``topology`` is a reference ``TopologyConfig``-like object; one of a
    single host is the flat mesh."""
    if topology is not None and getattr(topology, "num_hosts", 1) != 1:
        raise NotImplementedError(
            f"topology with num_hosts={topology.num_hosts} needs the "
            f"two-level composite across domains, which this port does "
            f"not have yet (ROADMAP A8b)")
    return mesh.axis_names[0], mesh.n, None
