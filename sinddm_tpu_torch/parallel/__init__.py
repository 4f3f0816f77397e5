"""The mesh and the multi-process runtime on ``torch.distributed`` (port of
``sinddm_tpu/parallel``). The JAX package's ``stage_replicated`` /
``stage_batch`` have no counterpart: every rank holds the whole state, so
nothing is staged."""

from sinddm_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize as initialize_distributed,
    is_primary,
)
from sinddm_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated_sharding,
)
