"""Data pipelines (port of ``repro/data``)."""
