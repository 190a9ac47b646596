"""Fleet-level helpers (torch port).  Only the step monitor is ported; the
mesh and sharding wait for the distribution entry of the ROADMAP."""
