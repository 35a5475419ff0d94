"""Launchers: ``python -m repro_torch.launch.serve`` serves a synthetic
stream on the card."""
