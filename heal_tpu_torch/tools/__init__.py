"""Entry points of the port (``python -m heal_tpu_torch.tools.inference``)."""
