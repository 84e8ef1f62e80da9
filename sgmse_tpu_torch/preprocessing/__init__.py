"""Corpus scripts of the port, each ``python -m
sgmse_tpu_torch.preprocessing.<name>`` with the flags of its counterpart in
``preprocessing/``: ``create_synthetic_speech`` (no external data),
``create_wsj0_chime3``, ``create_wsj0_qut`` and ``create_wsj0_reverb``, over
the shared ``mixing`` helpers."""
