"""The level-batched GOF encode (`gof.py`), the port of vpcc_tpu/parallel."""
