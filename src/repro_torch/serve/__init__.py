"""Serving on PyTorch.  Port of ``src/repro/serve``: the LM engine
(``engine.py``), the GNN-CV micro-batching engine (``gnncv.py``) and its
schedulers (``scheduler.py``)."""
from repro_torch.serve.engine import Request, ServeEngine   # noqa: F401
from repro_torch.serve.gnncv import (GNNCVServeEngine,      # noqa: F401
                                     TaskRequest)
from repro_torch.serve.scheduler import (Decision,          # noqa: F401
                                         FIFOScheduler, Scheduler,
                                         SLOScheduler, resolve_scheduler)
