"""Lowering: cut a model into the stage programs the executors run."""
