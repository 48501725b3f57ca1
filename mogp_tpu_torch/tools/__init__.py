"""Scripts run on a CUDA card; each module's docstring says how."""
