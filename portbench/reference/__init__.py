"""The plain reference: Python integers and NumPy only.

Nothing here imports the program under test (mina_bridge_tpu_torch), the
JAX package or JAX: the reference parses the committed fixtures and the
SRS files itself and works out again what it compares.
"""
