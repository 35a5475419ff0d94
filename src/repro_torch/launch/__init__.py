"""Launchers: ``python -m repro_torch.launch.serve`` serves a synthetic
stream on the card; ``python -m repro_torch.launch.train`` trains an LM
config on the synthetic token stream, resuming from its checkpoints."""
