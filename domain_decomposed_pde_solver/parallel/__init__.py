"""Domain decomposition: partitioners, halo plans, sharded operators."""

from .partition import (
    PartitionStats,
    build_dual_graph,
    edgecut,
    partition_graph,
    partition_mesh_elements,
    partition_rcb,
    partition_stats,
    refine_partition,
)
from .halo import HaloPlan, build_halo_plan
from .decompose import decompose_mesh, write_decomposition
from .ownership import node_ownership_from_element_partition
from .schwarz import build_block_amg
from .schwarzilu import build_block_ilu
from .slab import (
    SlabDIAPlan,
    SlabStencilOperator,
    build_slab_plan,
    build_slab_stencil,
    slab_cg_solve,
    slab_stencil_cg_solve,
)
from .haloamg import HaloAMG, build_halo_amg, halo_amg_cg_solve
from .slabamg import SlabAMG, build_slab_amg, slab_amg_cg_solve
from .multihost import (
    initialize_multihost,
    multihost_slab_cg_solve,
    put_global,
)
from .slabbrick import SlabBrickPrecond, build_slab_brick_precond
from .sharded import (
    ShardedOperator,
    make_device_mesh,
    sharded_cg_chunk,
    sharded_cg_solve,
    sharded_gmres_solve,
    sharded_power_method,
)

__all__ = [
    "PartitionStats",
    "build_dual_graph",
    "edgecut",
    "partition_graph",
    "partition_mesh_elements",
    "partition_rcb",
    "partition_stats",
    "refine_partition",
    "HaloPlan",
    "build_halo_plan",
    "decompose_mesh",
    "write_decomposition",
    "node_ownership_from_element_partition",
    "build_block_amg",
    "build_block_ilu",
    "SlabDIAPlan",
    "SlabStencilOperator",
    "build_slab_stencil",
    "slab_stencil_cg_solve",
    "SlabAMG",
    "build_slab_amg",
    "slab_amg_cg_solve",
    "HaloAMG",
    "build_halo_amg",
    "halo_amg_cg_solve",
    "initialize_multihost",
    "multihost_slab_cg_solve",
    "put_global",
    "build_slab_plan",
    "slab_cg_solve",
    "SlabBrickPrecond",
    "build_slab_brick_precond",
    "ShardedOperator",
    "make_device_mesh",
    "sharded_cg_chunk",
    "sharded_cg_solve",
    "sharded_gmres_solve",
    "sharded_power_method",
]
