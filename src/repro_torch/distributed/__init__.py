"""The LM's distribution layer.  Port of ``src/repro/distributed``: the
sharding rule table and its binding to a process mesh (``sharding.py``:
``shardings``, ``device_put``), the differentiable collectives the
sharded paths run on (``collectives.py``, which the reference takes from
``jax.lax``), and the GPipe schedule (``pipeline.py``)."""
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              device_put, param_specs,
                                              shardings)

__all__ = ["param_specs", "batch_specs", "cache_specs", "shardings",
           "device_put"]
