"""Fleet-level helpers (torch port): the logical sharding rules
(``sharding``), the per-shard dispatch of the fused kernels
(``shard_fused``), int8 gradient compression (``compression``) and the
step monitor (``monitor``), on ``torch.distributed``."""
