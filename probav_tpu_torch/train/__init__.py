"""Training: the shift-loss train step, optax-exact optimizers, the trainer
runtime and the CLI (``python3 -m probav_tpu_torch.train``, ``cli.py``)."""
