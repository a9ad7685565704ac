"""The storage pipeline (segments -> fragments -> tags)."""
from .pipeline import PipelineConfig, StoragePipeline  # noqa: F401
