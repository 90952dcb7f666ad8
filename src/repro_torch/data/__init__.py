"""The data pipeline of the port (the port of `repro.data`)."""

from .pipeline import SyntheticLMSource, Prefetcher, make_pipeline
