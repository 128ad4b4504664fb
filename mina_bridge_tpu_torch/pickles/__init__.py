"""See the package docstring; each module names its JAX counterpart."""
