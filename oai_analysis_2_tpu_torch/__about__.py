"""Version metadata (reference: oai_analysis/__about__.py:4)."""

__version__ = "2.0.0"
