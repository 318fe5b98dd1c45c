"""Deterministic synthetic data pipeline with sharding + prefetch (the
port's copy of the reference's ``repro/data``)."""

from .pipeline import (DataConfig, PrefetchIterator, SyntheticLM,  # noqa: F401
                       make_pipeline)
