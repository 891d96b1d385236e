"""Multi-process data parallelism (``dist.py``), the counterpart of
``wseg_tpu/parallel/mesh.py``'s ``data`` axis; the optimizer lives in
``wseg_tpu_torch/optim.py``."""
