"""Multi-process (SPMD) runtime of the port over ``torch.distributed``: the
process group (:mod:`.distributed`), the (data, model) mesh of ranks
(:mod:`.mesh`) and a single-host launcher (:mod:`.launch`)."""

from .distributed import (all_gather, all_reduce, initialize_distributed,  # noqa: F401
                          is_primary_host, rank_device)
from .launch import run_ranks  # noqa: F401
from .mesh import Mesh, keep_shards, make_mesh, param_shards  # noqa: F401
