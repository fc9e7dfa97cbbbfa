"""parallel layer of the PyTorch port (see mcbrat3d_tpu_torch): photon
data-parallel batches over torch.distributed ranks."""
