"""The benchmark of the PyTorch and CUDA port ``graphs4cfd_tpu_torch``
(see ``harness.py``)."""
