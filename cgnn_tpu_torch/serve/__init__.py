"""serve: see the package docstring of cgnn_tpu_torch."""
