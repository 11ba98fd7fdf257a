"""Developer tools that ship with the port (``rtlint``, the analyzer
behind ``python -m ray_tpu_torch lint``)."""
