"""The benchmark of mina_bridge_tpu_torch on one CUDA card (see run.py)."""
