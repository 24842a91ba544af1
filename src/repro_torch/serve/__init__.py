"""LM serving on PyTorch.  Port of ``src/repro/serve`` (``engine.py``)."""
from repro_torch.serve.engine import Request, ServeEngine   # noqa: F401
