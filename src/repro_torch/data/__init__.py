"""Deterministic synthetic data pipeline with resume-by-step semantics."""
from .pipeline import DataConfig, SyntheticLMDataset, make_batch_iterator

__all__ = ["DataConfig", "SyntheticLMDataset", "make_batch_iterator"]
