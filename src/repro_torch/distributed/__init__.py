"""The LM's distribution layer.  Port of ``src/repro/distributed``: the
sharding rule table (``sharding.py``).  Binding its specs to devices
(``shardings``) and the pipeline schedule (``pipeline.py``) are ROADMAP
queue 1 item 6's second half."""
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              param_specs, shardings)

__all__ = ["param_specs", "batch_specs", "cache_specs", "shardings"]
