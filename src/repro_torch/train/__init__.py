"""Training steps and checkpoints (port of ``repro/train``)."""
