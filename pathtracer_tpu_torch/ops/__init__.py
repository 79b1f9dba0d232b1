"""Device compute on torch tensors (see the package docstring)."""
