"""Multi-process data parallelism (``parallel.dist``), the port of
``mfvit_tpu/parallel``."""
