"""Plain PyTorch math on the render path: ``posenc``, ``sampling``,
``rendering`` (compositing) and ``ray_dict``."""
