"""spartan_tpu_torch: the PyTorch/CUDA port of spartan_tpu (Spartan NIZK
over ristretto255) for NVIDIA Hopper.  See README.md, "The PyTorch port"."""
