"""Multi-device scaling on ``torch.distributed``: the (data, spatial) mesh,
the sharded DCT, the distributed top-k, the DP/TP/corpus pipelines and the
staged (PP) schedule.

Port of the JAX package's ``parallel/``, one process per rank (NCCL on
CUDA cards, gloo on the CPU); :mod:`.launch` spawns ranks on one machine
and :mod:`.dryrun` drives every mode. Importing it starts no process and
joins no group.
"""

from . import dct_sharded, mesh, pipeline_sharded, pipeline_staged, topk_sharded
from .mesh import (DATA_AXIS, SPATIAL_AXIS, Local, batch_sharding, gather,
                   make_mesh, multihost_initialize, place, replicated)
from .pipeline_sharded import (
    embed_batch_sharded,
    embed_corpus,
    embed_spatial,
    extract_batch_sharded,
    extract_corpus,
    extract_spatial,
)
from .pipeline_staged import embed_staged, make_stage_mesh

__all__ = [
    "mesh", "dct_sharded", "topk_sharded", "pipeline_sharded",
    "pipeline_staged",
    "make_mesh", "batch_sharding", "DATA_AXIS", "SPATIAL_AXIS",
    "embed_batch_sharded", "extract_batch_sharded",
    "embed_spatial", "extract_spatial",
    "embed_staged", "make_stage_mesh",
    # The port's own: process groups, placement and the corpus pair.
    "multihost_initialize", "replicated", "place", "gather", "Local",
    "embed_corpus", "extract_corpus",
]
