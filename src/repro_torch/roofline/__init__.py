"""Roofline terms on the meta device and H100 constants (PyTorch port of
``repro.roofline``)."""
from . import analysis, hw  # noqa: F401
from .analysis import RooflineTerms, analyze, collective_bytes  # noqa: F401
