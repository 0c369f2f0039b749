"""Command-line entry points of the port: ``python -m
bridgerl_tpu_torch.cli.process_data`` and ``python -m
bridgerl_tpu_torch.cli.train_ablation``."""
