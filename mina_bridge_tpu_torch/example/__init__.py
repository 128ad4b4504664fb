"""The Sudoku bridge consumer on the port: the port's own copy of the
JAX package's example/ (sudoku_lib.py, sudoku_zkapp.py, app.py), proving
and verifying on the card.

    python -m mina_bridge_tpu_torch.example.app deploy-contract | validate-solution <zkapp-public-key>
"""
