"""Deterministic synthetic data pipeline (`synthetic.py` is a copy of
the JAX package's, numpy only), and a frontend stub that turns its
tokens into embeddings for the archs that take them."""
from .frontend import FrontendStub
from .synthetic import DataConfig, SyntheticLM

__all__ = ["DataConfig", "FrontendStub", "SyntheticLM"]
