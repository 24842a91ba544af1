"""Data pipelines: port of ``src/repro/data``."""
from repro_torch.data.pipeline import TokenPipeline, synthetic_embeds

__all__ = ["TokenPipeline", "synthetic_embeds"]
