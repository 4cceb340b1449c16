"""Model building blocks and the model zoo (attn/dense kinds so far)."""
