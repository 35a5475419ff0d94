"""The reference's sharding rules as spec logic over a mesh's axis sizes
(``repro_torch.sharding.rules``), for the dry run's per-device bytes."""
