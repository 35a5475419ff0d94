"""Launchers: ``python -m repro_torch.launch.serve`` serves a synthetic
stream on the card; ``python -m repro_torch.launch.train`` trains an LM
config on the synthetic token stream, resuming from its checkpoints.

The analysis layer needs no card: ``python -m repro_torch.launch.dryrun``
traces every (architecture × shape) cell on ``meta`` tensors and the ANNS
ring analytically, and ``python -m repro_torch.launch.roofline`` reads its
cache on the H100's rates (``mesh``: the meshes it describes; ``hlo``:
the collectives a virtual-mesh step stands in for)."""
