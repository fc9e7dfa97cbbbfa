"""spectral layer of the PyTorch port (see mcbrat3d_tpu_torch)."""
