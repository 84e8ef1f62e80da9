"""Quality tools of the port: ``learn_demo`` (train on a synthetic corpus,
enhance, score), ``bf16_quality`` and ``quality_vs_nfe``."""
