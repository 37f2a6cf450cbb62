from .pipeline import DataConfig, PrefetchIterator, SyntheticLM  # noqa: F401
